"""CLI end-to-end parity: drive the command surfaces against goldens."""

import os

import pytest

# each tool runs in this process, so a jit shape compiles once a worker
from conftest import fixture_path, jax_run as run_cli, wrap_60


@pytest.mark.parametrize("engine", ["tpu"])
def test_classify_cli_parity(tmp_path, engine):
    fx = fixture_path("synth")
    out = tmp_path / "out.tsv"
    report = tmp_path / "report.tsv"
    r = run_cli(["classify",
                 "-x", os.path.join(fx, "synth"),
                 "-U", os.path.join(fx, "reads.fq"),
                 "-S", str(out), "--report-file", str(report),
                 "--engine", engine])
    assert r.returncode == 0, r.stderr
    golden = open(os.path.join(fx, "golden_output.tsv")).read()
    assert out.read_text() == golden
    golden_rep = open(os.path.join(fx, "golden_report.tsv")).read()
    assert report.read_text() == golden_rep


def test_classify_cli_paired(tmp_path):
    fx = fixture_path("synth")
    out = tmp_path / "out.tsv"
    r = run_cli(["classify",
                 "-x", os.path.join(fx, "synth"),
                 "-1", os.path.join(fx, "reads_1.fq"),
                 "-2", os.path.join(fx, "reads_2.fq"),
                 "-S", str(out), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    golden = open(os.path.join(fx, "golden_paired.tsv")).read()
    assert out.read_text() == golden


def test_classify_cli_upto_skip(tmp_path):
    fx = fixture_path("synth")
    out = tmp_path / "out.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-U", os.path.join(fx, "reads.fq"),
                 "-S", str(out), "--report-file", "",
                 "-s", "10", "-u", "5"])
    assert r.returncode == 0, r.stderr
    lines = out.read_text().splitlines()
    assert len(lines) >= 6  # header + >= 5 reads (multi-matches may add rows)
    golden = open(os.path.join(fx, "golden_output.tsv")).read().splitlines()
    # rows for reads 10..14 must match the golden rows for those readIDs
    got_ids = {l.split("\t")[0] for l in lines[1:]}
    want_ids = set()
    seen = set()
    for l in golden[1:]:
        rid = l.split("\t")[0]
        seen.add(rid)
    assert got_ids <= seen


def test_kreport_cli_parity(tmp_path):
    fx = fixture_path("synth")
    golden_rows = open(os.path.join(fx, "golden_output.tsv")).read()
    r = run_cli(["kreport", "-x", os.path.join(fx, "synth")],
                input_text=golden_rows)
    assert r.returncode == 0, r.stderr
    golden_kr = open(os.path.join(fx, "golden_kreport.txt")).read()
    assert r.stdout == golden_kr


def test_inspect_cli(tmp_path):
    fx = fixture_path("synth")
    r = run_cli(["inspect", "-n", os.path.join(fx, "synth")])
    assert r.returncode == 0, r.stderr
    names = r.stdout.splitlines()
    assert names[0] == "seq0 synthetic genome"
    assert len(names) == 24

    # FASTA reconstruction must round-trip the original db
    r = run_cli(["inspect", os.path.join(fx, "synth")])
    assert r.returncode == 0, r.stderr
    # db.fa uses 70-char lines; normalize both sides
    def normalize(txt):
        seqs = {}
        name = None
        for line in txt.splitlines():
            if line.startswith(">"):
                name = line[1:]
                seqs[name] = []
            else:
                seqs[name].append(line)
        return {n: "".join(c) for n, c in seqs.items()}
    got = normalize(r.stdout)
    want = normalize(open(os.path.join(fx, "db.fa")).read())
    assert got == want

    # summary
    r = run_cli(["inspect", "-s", os.path.join(fx, "synth")])
    assert "SA-Sample\t1 in 16" in r.stdout
    assert "FTab-Chars\t10" in r.stdout


def test_inspect_taxonomy_dumps():
    fx = fixture_path("synth")
    r = run_cli(["inspect", "--conversion-table", os.path.join(fx, "synth")])
    assert r.stdout.splitlines()[0] == "seq0\t1000"
    r = run_cli(["inspect", "--taxonomy-tree", os.path.join(fx, "synth")])
    assert "1\t|\t1\t|\tno rank" in r.stdout
    r = run_cli(["inspect", "--name-table", os.path.join(fx, "synth")])
    assert "1\troot" in r.stdout
    r = run_cli(["inspect", "--size-table", os.path.join(fx, "synth")])
    assert "1000\t40000" in r.stdout


def test_build_cli(tmp_path):
    fx = fixture_path("synth")
    base = str(tmp_path / "cli_idx")
    r = run_cli(["build", "--conversion-table", os.path.join(fx, "conv.dmp"),
                 "--taxonomy-tree", os.path.join(fx, "nodes.dmp"),
                 "--name-table", os.path.join(fx, "names.dmp"),
                 "-q", os.path.join(fx, "db.fa"), base])
    assert r.returncode == 0, r.stderr
    import filecmp
    for ext in ("1", "2", "3", "4"):
        assert filecmp.cmp(f"{base}.{ext}.cf",
                           os.path.join(fx, f"synth.{ext}.cf"),
                           shallow=False)


def test_promote_cli(tmp_path):
    fx = fixture_path("synth")
    golden_rows = open(os.path.join(fx, "golden_output.tsv")).read()
    r = run_cli(["promote", os.path.join(fx, "synth"), "-", "genus"],
                input_text=golden_rows)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("readID")
    # every species taxID (1000+) must now be a genus (100..103) or
    # unpromotable id
    for line in lines[1:]:
        tid = int(line.split("\t")[2])
        assert tid < 1000 or tid == 0 or tid == 1 or tid >= 10


def test_classify_sam_and_formats(tmp_path):
    fx = fixture_path("synth")
    out = tmp_path / "out.sam.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-U", os.path.join(fx, "reads.fq"), "-u", "5",
                 "-S", str(out), "--report-file", "", "--out-fmt", "sam"])
    assert r.returncode == 0, r.stderr
    lines = out.read_text().splitlines()
    assert lines[0].split("\t") == ["QNAME", "FLAG", "RNAME", "POS", "MAPQ",
                                    "CIGAR", "RNEXT", "PNEXT", "TLEN", "SEQ",
                                    "QUAL"]
    parts = lines[1].split("\t")
    assert parts[1] == "0" and parts[5] == "*"
    assert set(parts[9]) <= set("ACGTN")

    # raw one-per-line input
    raw = tmp_path / "reads.raw"
    raw.write_text("ACGTACGTACGTACGTACGTACGTACGTACGT\n")
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-U", str(raw), "-r", "-S", "-", "--report-file", ""])
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("\n") == 2  # header + 1 read

    # --un teeing: junk reads must land in the un file
    un = tmp_path / "un.fq"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-U", os.path.join(fx, "reads.fq"), "-u", "200",
                 "-S", str(tmp_path / "o.tsv"), "--report-file", "",
                 "--un", str(un)])
    assert r.returncode == 0, r.stderr
    un_text = un.read_text()
    assert un_text.count("@") >= 1  # some junk reads in first 200
    assert "junk_" in un_text


def test_classify_cmdline_reads():
    fx = fixture_path("synth")
    db = open(os.path.join(fx, "db.fa")).read().splitlines()
    frag = db[1][:40]  # 40bp of seq0 -> classifies to taxID 1000
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"), "-c",
                 "-S", "-", "--report-file", "", frag])
    assert r.returncode == 0, r.stderr
    rows = r.stdout.splitlines()
    assert len(rows) == 2
    assert rows[1].split("\t")[2] == "1000"


def test_classify_metrics_emission(tmp_path):
    fx = fixture_path("synth")
    met = tmp_path / "met.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-U", os.path.join(fx, "reads.fq"), "-u", "100",
                 "-S", str(tmp_path / "o.tsv"), "--report-file", "",
                 "--met-file", str(met), "--met", "1"])
    assert r.returncode == 0, r.stderr
    lines = met.read_text().splitlines()
    # reference header: 134 bowtie2-heritage names (its /*N*/ comment
    # numbering skips 32-33), trailing tab (centrifuge.cpp:1818-1967);
    # rows are the 30 emitted values
    assert lines[0].startswith("Time\tRead\tBase\tSameRead")
    assert lines[0].endswith("LocalGenomeCoords\t")
    assert len(lines[0].rstrip("\t").split("\t")) == 134
    last = lines[-1].split("\t")
    assert len(last) == 30
    assert int(last[1]) == 100  # Read counter (final row = job total)
    assert int(last[5]) == 100  # UnfilteredRead
    assert int(last[14]) > 0    # MemPeak MB
    assert int(last[16]) > 0    # EbwtMemPeak MB


def test_sample_sheet(tmp_path):
    fx = fixture_path("synth")
    sheet = tmp_path / "sheet.tsv"
    o1, r1 = tmp_path / "s1.tsv", tmp_path / "s1_rep.tsv"
    o2, r2 = tmp_path / "s2.tsv", tmp_path / "s2_rep.tsv"
    sheet.write_text(
        f"1\t{os.path.join(fx, 'reads.fq')}\t\t{o1}\t{r1}\n"
        f"2\t{os.path.join(fx, 'reads_1.fq')}\t{os.path.join(fx, 'reads_2.fq')}\t{o2}\t{r2}\n")
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "--sample-sheet", str(sheet)])
    assert r.returncode == 0, r.stderr
    # sample 1 output == golden unpaired; sample 2 == golden paired
    assert o1.read_text() == open(os.path.join(fx, "golden_output.tsv")).read()
    assert o2.read_text() == open(os.path.join(fx, "golden_paired.tsv")).read()
    assert r1.read_text() == open(os.path.join(fx, "golden_report.tsv")).read()
    assert r2.read_text() == open(
        os.path.join(fx, "golden_paired_report.tsv")).read()


def test_eval_cli(tmp_path):
    fx = fixture_path("synth")
    prefix = str(tmp_path / "sim")
    r = run_cli(["simulate", "-x", os.path.join(fx, "db.fa"),
                 "--conversion-table", os.path.join(fx, "conv.dmp"),
                 "-o", prefix, "--num", "100", "--seed", "3"])
    assert r.returncode == 0, r.stderr
    assert os.path.exists(prefix + ".fq")

    # classify then evaluate through the CLI surfaces
    out = tmp_path / "c.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-U", prefix + ".fq", "-S", str(out), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    r = run_cli(["evaluate", "-x", os.path.join(fx, "synth"), str(out)])
    assert r.returncode == 0, r.stderr
    assert "genus\t" in r.stdout


def test_paired_streaming_parity(tmp_path):
    """classify_stream_paired must equal the batch path (golden)."""
    fx = fixture_path("synth")
    out = tmp_path / "p.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-1", os.path.join(fx, "reads_1.fq"),
                 "-2", os.path.join(fx, "reads_2.fq"),
                 "--batch-size", "256",
                 "-S", str(out), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    golden = open(os.path.join(fx, "golden_paired.tsv")).read()
    assert out.read_text() == golden


@pytest.mark.parametrize("flags,golden", [
    ([], "golden_kreport_k20.txt"),
    (["--no-lca"], "golden_kreport_k20_nolca.txt"),
    (["--min-score", "1000"], "golden_kreport_minscore.txt"),
])
def test_kreport_variants(flags, golden):
    fx = fixture_path("synth")
    src = "golden_k20.tsv" if "k20" in golden else "golden_output.tsv"
    rows = open(os.path.join(fx, src)).read()
    r = run_cli(["kreport", "-x", os.path.join(fx, "synth")] + flags,
                input_text=rows)
    assert r.returncode == 0, r.stderr
    want = open(os.path.join(fx, golden)).read()
    assert r.stdout == want


def test_classify_paired_k1(tmp_path):
    fx = fixture_path("synth")
    out = tmp_path / "pk1.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-1", os.path.join(fx, "reads_1.fq"),
                 "-2", os.path.join(fx, "reads_2.fq"), "-k", "1",
                 "-S", str(out), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    assert out.read_text() == open(
        os.path.join(fx, "golden_paired_k1.tsv")).read()


@pytest.mark.parametrize("flag,reads,golden", [
    ("--qseq", "reads.qseq", "golden_qseq.tsv"),
    ("-r", "reads.raw", "golden_raw.tsv"),
])
def test_input_format_parity(tmp_path, flag, reads, golden):
    fx = fixture_path("synth")
    out = tmp_path / "o.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"), flag,
                 "-U", os.path.join(fx, reads),
                 "-S", str(out), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    assert out.read_text() == open(os.path.join(fx, golden)).read()


@pytest.mark.parametrize("flag,golden", [
    ("-n", "names"), ("-s", "summary"),
    ("--conversion-table", "conv"), ("--taxonomy-tree", "tree"),
    ("--name-table", "nametab"), ("--size-table", "sizetab"),
])
def test_inspect_byte_parity(flag, golden):
    """Every inspect dump must byte-match the reference binary's output
    (goldens in fixtures/synth/inspect/ generated by centrifuge-inspect-bin)."""
    fx = fixture_path("synth")
    r = run_cli(["inspect", flag, os.path.join(fx, "synth")])
    assert r.returncode == 0, r.stderr
    want = open(os.path.join(fx, "inspect", f"golden_{golden}.txt")).read()
    assert r.stdout == want


def test_inspect_fasta_byte_parity():
    """Default FASTA reconstruction byte-matches the reference binary
    (equivalently: db.fa re-wrapped at 60 chars/line)."""
    fx = fixture_path("synth")
    want = wrap_60(os.path.join(fx, "db.fa"))
    r = run_cli(["inspect", os.path.join(fx, "synth")])
    assert r.stdout == want


def test_custom_columns_parity(tmp_path):
    """--tab-fmt-cols with taxRank/taxName/readSeq vs reference golden."""
    fx = fixture_path("synth")
    out = tmp_path / "cols.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-U", os.path.join(fx, "reads.fq"), "-u", "300",
                 "--tab-fmt-cols", "readID,taxID,taxRank,taxName,score,readSeq",
                 "-S", str(out), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    assert out.read_text() == open(os.path.join(fx, "golden_cols.tsv")).read()


@pytest.mark.parametrize("rank,src,golden", [
    ("species", "golden_output.tsv", "golden_promote_species.tsv"),
    ("lca", "golden_k20.tsv", "golden_promote_lca.tsv"),
])
def test_promote_byte_parity(rank, src, golden):
    """Promote output must byte-match the reference Perl script."""
    fx = fixture_path("synth")
    r = run_cli(["promote", os.path.join(fx, "synth"),
                 os.path.join(fx, src), rank])
    assert r.returncode == 0, r.stderr
    assert r.stdout == open(os.path.join(fx, golden)).read()


def test_kreport_count_table_parity():
    """--is-count-table mode vs reference golden."""
    fx = fixture_path("synth")
    counts = open(os.path.join(fx, "counts.tsv")).read()
    r = run_cli(["kreport", "-x", os.path.join(fx, "synth"),
                 "--is-count-table"], input_text=counts)
    assert r.returncode == 0, r.stderr
    assert r.stdout == open(
        os.path.join(fx, "golden_kreport_counts.txt")).read()


# ---------------------------------------------------------------------------
# round-2 surface: vestigial strand flags, QC filter, quality encodings,
# mixed tabbed input, wrapper-parity read tees
# ---------------------------------------------------------------------------

def test_nofw_norc_parity(tmp_path):
    """--nofw/--norc are stored but never consulted by the reference
    classifier (hi_aligner.h:745-748 are the only writes; verified
    output-identical with the reference binary on this fixture)."""
    fx = fixture_path("synth")
    out = tmp_path / "o.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-U", os.path.join(fx, "reads.fq"), "--nofw", "--norc",
                 "-S", str(out), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    assert out.read_text() == open(
        os.path.join(fx, "golden_nofw.tsv")).read()


def test_qc_filter_parity(tmp_path):
    """--qc-filter drops qseq reads whose filter field is '0'
    (centrifuge.cpp:2578-2584); reference-generated golden."""
    fx = fixture_path("synth")
    out = tmp_path / "o.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"), "--qseq",
                 "-U", os.path.join(fx, "reads_filter.qseq"), "--qc-filter",
                 "-S", str(out), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    assert out.read_text() == open(
        os.path.join(fx, "golden_qcfilter.tsv")).read()


QUAL_COLS = ("readID,seqID,taxID,score,2ndBestScore,hitLength,queryLength,"
             "numMatches,readQual")


@pytest.mark.parametrize("flag,reads,golden", [
    ("--phred64", "reads_phred64.fq", "golden_phred64.tsv"),
    ("--solexa-quals", "reads_solexa.fq", "golden_solexa.tsv"),
    ("--int-quals", "reads_intq.fq", "golden_intq.tsv"),
])
def test_quality_encoding_parity(tmp_path, flag, reads, golden):
    """Qualities normalize to phred+33 at parse time (qual.h:105-171);
    the readQual column in the golden pins the converted bytes."""
    fx = fixture_path("synth")
    out = tmp_path / "o.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"), flag,
                 "-U", os.path.join(fx, reads),
                 "--tab-fmt-cols", QUAL_COLS,
                 "-S", str(out), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    assert out.read_text() == open(os.path.join(fx, golden)).read()


def test_tab12_mixed_rows(tmp_path):
    """--12 with interleaved 5-field pairs and 3-field singles: the
    reference BINARY's --12 path is dead (centrifuge.cpp:3018 builds an
    empty mate12 list, so --12 input is silently ignored); ours
    classifies every row. Golden derived from reference -1/-2 and -U
    runs on the split parts, interleaved in input order."""
    fx = fixture_path("synth")
    out = tmp_path / "o.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "--12", os.path.join(fx, "reads_mixed.tab"),
                 "-S", str(out), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    assert out.read_text() == open(
        os.path.join(fx, "golden_tab12_mixed.tsv")).read()


def test_tab5_tab6_paired(tmp_path):
    """--tab5/--tab6 paired tabbed formats (centrifuge.cpp:976-977).
    The reference BINARY also ignores these (same dead mates12 list as
    --12, centrifuge.cpp:3007), so the expected bytes are the reference
    run on the equivalent -1/-2 files: identical seqs/quals, and the
    per-read seed only uses the name up to '/' (pat.h:55-91), so the
    tab5 shared name and the tab6 /1 name both hash identically."""
    fx = fixture_path("synth")
    for flag, fixture in (("--tab5", "reads_pairs.tab5"),
                          ("--tab6", "reads_pairs.tab6")):
        out = tmp_path / f"o{flag[2:]}.tsv"
        r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                     flag, os.path.join(fx, fixture),
                     "-S", str(out), "--report-file", ""])
        assert r.returncode == 0, r.stderr
        assert out.read_text() == open(
            os.path.join(fx, "golden_paired.tsv")).read(), flag


def test_sample_parity(tmp_path):
    """--sample 0.5: pseudo-random per-read sampling gate, byte-exact vs
    the reference binary (centrifuge.cpp:2459-2462 incl. the swapped-arg
    ROTL macro at :2229 that rotates the constant 2 by `seed` bits)."""
    fx = fixture_path("synth")
    out = tmp_path / "o.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-U", os.path.join(fx, "reads.fq"),
                 "--sample", "0.5",
                 "-S", str(out), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    assert out.read_text() == open(
        os.path.join(fx, "golden_sample50.tsv")).read()


def test_sample_upto_budget(tmp_path):
    """--sample with -u: sampled-out reads still consume the -u budget
    (the reference gates on rdid < qUpto before the sample draw,
    centrifuge.cpp:2463)."""
    fx = fixture_path("synth")
    out = tmp_path / "o.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-U", os.path.join(fx, "reads.fq"),
                 "--sample", "0.5", "-u", "1500",
                 "-S", str(out), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    assert out.read_text() == open(
        os.path.join(fx, "golden_sample50_u1500.tsv")).read()


def test_reference_flag_surface_parses():
    """Every long option the reference binary accepts
    (centrifuge.cpp:530-706) parses here with the same arity, so any
    reference command line runs unmodified; bowtie2-legacy tuning
    options are documented no-ops."""
    from centrifuge_tpu.cli.classify import make_parser
    p = make_parser()
    args = p.parse_args(
        ["-x", "i", "-U", "r",
         "--local", "--end-to-end", "--all", "--ff", "--fr", "--rf",
         "--no-mixed", "--no-discordant", "--dovetail", "--verbose",
         "--ma", "2", "--mp", "6,2", "--np", "1", "--rdg", "5,3",
         "--rfg", "5,3", "--score-min", "L,0,1.15", "--min-score", "60",
         "--dpad", "15", "--gbar", "4", "--seedlen", "22",
         "--multiseed", "L,1,1.15", "--wrapper", "basic-0",
         "-a", "-I", "0", "-X", "500", "-N", "0", "-L", "20",
         "--qupto", "100", "--khits", "3", "--metrics", "5",
         "--metrics-file", "m.tsv", "--metrics-stderr",
         "--phred33-quals", "--nondeterministic"])
    assert args.upto == 100 and args.khits == 3
    assert args.met == 5 and args.met_file == "m.tsv" and args.met_stderr
    assert args.non_deterministic


def test_paired_seq_cols_parity(tmp_path):
    """Paired readSeq/readQual join mates with '_' (aln_sink.h:2307-2310)."""
    fx = fixture_path("synth")
    out = tmp_path / "o.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-1", os.path.join(fx, "reads_1.fq"),
                 "-2", os.path.join(fx, "reads_2.fq"),
                 "--tab-fmt-cols", "readID,seqID,taxID,score,readSeq,readQual",
                 "-S", str(out), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    assert out.read_text() == open(
        os.path.join(fx, "golden_paired_seqcols.tsv")).read()


def test_read_tee_unpaired(tmp_path):
    """--un/--al write per-ROW FASTQ records exactly like the Perl
    wrapper (centrifuge:874-896); goldens from the wrapper itself."""
    fx = fixture_path("synth")
    out = tmp_path / "o.tsv"
    un = tmp_path / "un.fq"
    al = tmp_path / "al.fq"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-U", os.path.join(fx, "reads.fq"),
                 "--un", str(un), "--al", str(al),
                 "-S", str(out), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    # main TSV must NOT contain the internally injected seq/qual columns
    assert out.read_text() == open(
        os.path.join(fx, "golden_output.tsv")).read()
    assert un.read_text() == open(
        os.path.join(fx, "golden_tee_un.fq")).read()
    assert al.read_text() == open(
        os.path.join(fx, "golden_tee_al.fq")).read()


def test_read_tee_conc_and_gz(tmp_path):
    """--al-conc splits paired rows into two mate files
    (centrifuge:898-928); -gz variants compress (decompressed bytes
    compared: gzip headers embed timestamps)."""
    import gzip
    fx = fixture_path("synth")
    out = tmp_path / "o.tsv"
    alc = tmp_path / "alc.fq"
    unc = tmp_path / "unc.fq.gz"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-1", os.path.join(fx, "reads_1.fq"),
                 "-2", os.path.join(fx, "reads_2.fq"),
                 "--al-conc", str(alc), "--un-conc-gz", str(unc),
                 "-S", str(out), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    assert out.read_text() == open(
        os.path.join(fx, "golden_paired.tsv")).read()
    assert (tmp_path / "alc.1.fq").read_text() == open(
        os.path.join(fx, "golden_tee_alc.1.fq")).read()
    assert (tmp_path / "alc.2.fq").read_text() == open(
        os.path.join(fx, "golden_tee_alc.2.fq")).read()
    # all pairs classify on this fixture: un-conc files exist and are empty
    with gzip.open(str(tmp_path / "unc.fq.1.gz")) as f:
        assert f.read() == b""


def test_mate_file_mismatch_errors(tmp_path):
    """Unequal -1/-2 read counts abort like the reference
    (pat.cpp:270-279), instead of silently truncating."""
    fx = fixture_path("synth")
    short = tmp_path / "short_2.fq"
    lines = open(os.path.join(fx, "reads_2.fq")).read().splitlines()
    short.write_text("\n".join(lines[:len(lines) - 8]) + "\n")
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-1", os.path.join(fx, "reads_1.fq"),
                 "-2", str(short), "-S", str(tmp_path / "o.tsv"),
                 "--report-file", ""])
    assert r.returncode == 1
    assert "fewer reads in file specified with -2" in r.stderr


def test_kreport_count_table_degenerate_parity():
    """Duplicate taxID rows overwrite (last wins) while the total sums
    every row, and dotted lo.hi ids count only toward the total --
    exactly the Perl script's behaviour (centrifuge-kreport:72-77)."""
    fx = fixture_path("synth")
    counts = open(os.path.join(fx, "counts_dup.tsv")).read()
    r = run_cli(["kreport", "-x", os.path.join(fx, "synth"),
                 "--is-count-table"], input_text=counts)
    assert r.returncode == 0, r.stderr
    assert r.stdout == open(
        os.path.join(fx, "golden_kreport_counts_dup.txt")).read()


def test_met_read_per_read_metrics(tmp_path):
    """--met-read writes one metrics row per read (the reference's
    per-read reportInterval, centrifuge.cpp:2742-2748)."""
    fx = fixture_path("synth")
    met = tmp_path / "met.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-U", os.path.join(fx, "reads.fq"),
                 "--met-read", str(met),
                 "-S", str(tmp_path / "o.tsv"), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    lines = met.read_text().splitlines()
    # per-read records: reference row prefixed with Name
    # (centrifuge.cpp:2742-2748)
    assert lines[0].startswith("Name\tTime\tRead")
    assert len(lines) == 3001  # header + one row per read
    first = lines[1].split("\t")
    assert first[0] == "chim_0"
    assert first[2] == "1"      # Read: that read's own counters


def test_fastq_malformed_diagnostics(tmp_path):
    """Malformed FASTQ fails with a clear diagnostic (pat.cpp-style)
    instead of silently misparsing; blank lines between records are ok."""
    fx = fixture_path("synth")
    ok = tmp_path / "ok.fq"
    ok.write_text("@r1\nACGTACGTACGTACGTACGTACGTA\n+\n"
                  "IIIIIIIIIIIIIIIIIIIIIIIII\n\n"
                  "@r2\nACGTACGTACGTACGTACGTACGTA\n+\n"
                  "IIIIIIIIIIIIIIIIIIIIIIIII\n")
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-U", str(ok), "-S", str(tmp_path / "o.tsv"),
                 "--report-file", ""])
    assert r.returncode == 0, r.stderr
    assert len((tmp_path / "o.tsv").read_text().splitlines()) == 3

    bad = tmp_path / "bad.fq"
    bad.write_text("@r1\nACGTACGT\n+\nIIII\n")   # short quals
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-U", str(bad), "-S", str(tmp_path / "o2.tsv"),
                 "--report-file", ""])
    assert r.returncode != 0
    assert "quality values than read characters" in (r.stderr + r.stdout)


@pytest.mark.parametrize("nceil,golden", [
    ("L,0,0.02", "golden_nceil.tsv"),
    ("C,3", "golden_nceil_c3.tsv"),
])
def test_n_ceil_parity(tmp_path, nceil, golden):
    """--n-ceil C/L function forms drive the N filter
    (centrifuge.cpp:1323-1347, scoring nCeil); reference goldens on
    N-laden reads."""
    fx = fixture_path("synth")
    out = tmp_path / "o.tsv"
    r = run_cli(["classify", "-x", os.path.join(fx, "synth"),
                 "-U", os.path.join(fx, "reads_n.fq"),
                 "--n-ceil", nceil,
                 "-S", str(out), "--report-file", ""])
    assert r.returncode == 0, r.stderr
    assert out.read_text() == open(os.path.join(fx, golden)).read()
