"""The port held to the reference's parity surface on the CPU: every case
of chip_smoke.PARITY_CASES (the configurations of the JAX package's
tests/test_cli.py, test_parity.py and test_parity_configs.py) through
the port's classify CLI, on route a (the CLI as a user runs it, rows
resolved by the host walk), byte-equal to the reference goldens; and
the rest of the JAX CLI's surface, which has no golden, checked as the
JAX tests check it. Route b (the device resolve) is
tests/test_torch_parity_device.py, routes c and d
test_torch_parity_wide.py and test_torch_parity_mesh.py.

The goldens are the reference binaries' outputs, and the JAX package's
tests hold it to the same files, so no JAX run is needed here."""

import os

import pytest

import chip_smoke
from conftest import fixture_path
from test_torch_twin import one_torch_thread  # noqa: F401

FX = fixture_path("synth")
SYN = os.path.join(FX, "synth")


@pytest.fixture(scope="module")
def port():
    return chip_smoke.load_port()


@pytest.fixture(scope="module")
def shared():
    """The module's one DeviceFMIndex of each index (parity_pipe)."""
    return {}


def check_route(port, shared, case, route, tmp_path):
    """run_parity_case on the CPU: the plain versions of the kernels."""
    fault = chip_smoke.run_parity_case(port, case, route, shared, "cpu",
                                       str(tmp_path))
    assert fault is None, fault


@pytest.mark.parametrize("case", chip_smoke.PARITY_CASES,
                         ids=[c.name for c in chip_smoke.PARITY_CASES])
def test_parity_host_resolve(port, shared, case, tmp_path):
    """Route a: each case's outputs byte-equal to its goldens, its rows
    resolved by the host walk (HostResolver)."""
    check_route(port, shared, case, "a", tmp_path)


def test_parity_cases_cover_the_goldens():
    """Every classify golden of tests/fixtures/synth is some case's, and
    the cases of routes c and d are those that change the kernels'
    inputs."""
    used = {g for c in chip_smoke.PARITY_CASES if c.fixture == "synth"
            for _, g in c.goldens if g}
    want = {f for f in os.listdir(FX) if f.startswith("golden_")
            and not f.startswith(("golden_kreport", "golden_promote"))}
    assert want == used
    assert len(chip_smoke.PARITY_CASES) == 30
    assert [c.name for c in chip_smoke.PARITY_CASES if c.device_work] == [
        "output", "k1", "k3", "k20", "minhit16", "nofw", "paired",
        "paired_k1", "nceil", "nceil_c3", "qcfilter", "tab12_mixed", "trim",
        "nfail_paired"]


# ---- the JAX CLI's surface that has no golden (tests/test_cli.py) ----

def cli(argv, capsys, engine="gpu"):
    """(exit code, stdout, stderr) of the port's classify CLI on the synth
    index, in this process; --device cpu for the gpu engine."""
    from centrifuge_tpu_torch.cli import classify
    dev = ["--device", "cpu"] if engine == "gpu" else ["--engine", engine]
    try:
        rc = classify.run(["-x", SYN] + argv + dev)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def rows_of(path):
    with open(path) as f:
        return f.read()


def test_sam_and_formats(tmp_path, capsys):
    """test_cli.py test_classify_sam_and_formats: the SAM header and a
    row's flag, CIGAR and bases; one raw read; --un holds the junk reads.
    Each output equal to the numpy oracle engine's."""
    outs = {}
    for engine in ("gpu", "oracle"):
        out = tmp_path / f"{engine}.sam.tsv"
        rc, _, err = cli(["-U", f"{FX}/reads.fq", "-u", "5", "-S", str(out),
                          "--report-file", "", "--out-fmt", "sam"], capsys,
                         engine)
        assert rc == 0, err
        outs[engine] = out.read_text()
    assert outs["gpu"] == outs["oracle"]
    lines = outs["gpu"].splitlines()
    assert lines[0].split("\t") == ["QNAME", "FLAG", "RNAME", "POS", "MAPQ",
                                    "CIGAR", "RNEXT", "PNEXT", "TLEN", "SEQ",
                                    "QUAL"]
    parts = lines[1].split("\t")
    assert parts[1] == "0" and parts[5] == "*"
    assert set(parts[9]) <= set("ACGTN")

    raw = tmp_path / "reads.raw"
    raw.write_text("ACGTACGTACGTACGTACGTACGTACGTACGT\n")
    rc, out, err = cli(["-U", str(raw), "-r", "-S", "-", "--report-file",
                        ""], capsys)
    assert rc == 0, err
    assert out.count("\n") == 2    # header + 1 read

    un = tmp_path / "un.fq"
    rc, _, err = cli(["-U", f"{FX}/reads.fq", "-u", "200", "-S",
                      str(tmp_path / "o.tsv"), "--report-file", "", "--un",
                      str(un)], capsys)
    assert rc == 0, err
    assert un.read_text().count("@") >= 1 and "junk_" in un.read_text()


def test_cmdline_reads(capsys):
    """test_cli.py test_classify_cmdline_reads: -c with 40 bp of seq0
    gives one row, taxID 1000, as the oracle engine does."""
    with open(os.path.join(FX, "db.fa")) as f:
        frag = f.read().splitlines()[1][:40]
    got = {}
    for engine in ("gpu", "oracle"):
        rc, out, err = cli(["-c", "-S", "-", "--report-file", "", frag],
                           capsys, engine)
        assert rc == 0, err
        got[engine] = out
    assert got["gpu"] == got["oracle"]
    rows = got["gpu"].splitlines()
    assert len(rows) == 2 and rows[1].split("\t")[2] == "1000"


def test_metrics_emission(tmp_path, capsys):
    """test_cli.py test_classify_metrics_emission: --met-file at --met 1:
    the reference header (134 names, trailing tab), 30-value rows, the
    last one the job total of 100 reads, memory peaks above 0."""
    met = tmp_path / "met.tsv"
    rc, _, err = cli(["-U", f"{FX}/reads.fq", "-u", "100", "-S",
                      str(tmp_path / "o.tsv"), "--report-file", "",
                      "--met-file", str(met), "--met", "1"], capsys)
    assert rc == 0, err
    lines = met.read_text().splitlines()
    assert lines[0].startswith("Time\tRead\tBase\tSameRead")
    assert lines[0].endswith("LocalGenomeCoords\t")
    assert len(lines[0].rstrip("\t").split("\t")) == 134
    last = lines[-1].split("\t")
    assert len(last) == 30
    assert int(last[1]) == 100 and int(last[5]) == 100
    assert int(last[14]) > 0 and int(last[16]) > 0


def test_sample_sheet(tmp_path, capsys):
    """test_cli.py test_sample_sheet: an unpaired and a paired sample,
    each output and report byte-equal to its golden."""
    sheet = tmp_path / "sheet.tsv"
    o1, r1 = tmp_path / "s1.tsv", tmp_path / "s1_rep.tsv"
    o2, r2 = tmp_path / "s2.tsv", tmp_path / "s2_rep.tsv"
    sheet.write_text(
        f"1\t{FX}/reads.fq\t\t{o1}\t{r1}\n"
        f"2\t{FX}/reads_1.fq\t{FX}/reads_2.fq\t{o2}\t{r2}\n")
    rc, _, err = cli(["--sample-sheet", str(sheet)], capsys)
    assert rc == 0, err
    for got, gold in ((o1, "golden_output.tsv"), (o2, "golden_paired.tsv"),
                      (r1, "golden_report.tsv"),
                      (r2, "golden_paired_report.tsv")):
        assert got.read_text() == rows_of(os.path.join(FX, gold)), gold


def test_upto_skip(tmp_path, capsys):
    """test_cli.py test_classify_cli_upto_skip: -s 10 -u 5 classifies
    reads 10-14, rows of readIDs the golden holds; here also equal to the
    oracle engine's rows and to the golden's rows of those reads."""
    got = {}
    for engine in ("gpu", "oracle"):
        out = tmp_path / f"{engine}.tsv"
        rc, _, err = cli(["-U", f"{FX}/reads.fq", "-S", str(out),
                          "--report-file", "", "-s", "10", "-u", "5"],
                         capsys, engine)
        assert rc == 0, err
        got[engine] = out.read_text()
    assert got["gpu"] == got["oracle"]
    lines = got["gpu"].splitlines()
    assert len(lines) >= 6
    golden = rows_of(os.path.join(FX, "golden_output.tsv")).splitlines()
    ids = {ln.split("\t")[0] for ln in lines[1:]}
    assert len(ids) == 5
    assert lines[1:] == [ln for ln in golden[1:]
                         if ln.split("\t")[0] in ids]


def test_tab5_tab6_paired(tmp_path, capsys):
    """test_cli.py test_tab5_tab6_paired: --tab5 and --tab6 pairs
    byte-equal to golden_paired.tsv (the reference run on the -1/-2
    files)."""
    for flag, fixture in (("--tab5", "reads_pairs.tab5"),
                          ("--tab6", "reads_pairs.tab6")):
        out = tmp_path / f"o{flag[2:]}.tsv"
        rc, _, err = cli([flag, f"{FX}/{fixture}", "-S", str(out),
                          "--report-file", ""], capsys)
        assert rc == 0, err
        assert out.read_text() == rows_of(
            os.path.join(FX, "golden_paired.tsv")), flag


def test_met_read_per_read_metrics(tmp_path, capsys):
    """test_cli.py test_met_read_per_read_metrics: one metrics row a read,
    prefixed with its name, each holding that read's own counters."""
    met = tmp_path / "met.tsv"
    rc, _, err = cli(["-U", f"{FX}/reads.fq", "--met-read", str(met), "-S",
                      str(tmp_path / "o.tsv"), "--report-file", ""], capsys)
    assert rc == 0, err
    lines = met.read_text().splitlines()
    assert lines[0].startswith("Name\tTime\tRead")
    assert len(lines) == 3001
    first = lines[1].split("\t")
    assert first[0] == "chim_0" and first[2] == "1"


def test_fastq_malformed_diagnostics(tmp_path, capsys):
    """test_cli.py test_fastq_malformed_diagnostics: blank lines between
    records are read; a record with fewer qualities than bases fails with
    the reference's diagnostic (in process the error propagates, as the
    JAX CLI's does to its exit code)."""
    ok = tmp_path / "ok.fq"
    ok.write_text("@r1\nACGTACGTACGTACGTACGTACGTA\n+\n"
                  "IIIIIIIIIIIIIIIIIIIIIIIII\n\n"
                  "@r2\nACGTACGTACGTACGTACGTACGTA\n+\n"
                  "IIIIIIIIIIIIIIIIIIIIIIIII\n")
    rc, _, err = cli(["-U", str(ok), "-S", str(tmp_path / "o.tsv"),
                      "--report-file", ""], capsys)
    assert rc == 0, err
    assert len((tmp_path / "o.tsv").read_text().splitlines()) == 3

    bad = tmp_path / "bad.fq"
    bad.write_text("@r1\nACGTACGT\n+\nIIII\n")
    with pytest.raises(ValueError,
                       match="quality values than read characters"):
        cli(["-U", str(bad), "-S", str(tmp_path / "o2.tsv"),
             "--report-file", ""], capsys)


def test_mate_file_mismatch_errors(tmp_path, capsys):
    """test_cli.py test_mate_file_mismatch_errors: -2 shorter than -1
    exits 1 with the reference's message."""
    short = tmp_path / "short_2.fq"
    lines = rows_of(os.path.join(FX, "reads_2.fq")).splitlines()
    short.write_text("\n".join(lines[:len(lines) - 8]) + "\n")
    rc, _, err = cli(["-1", f"{FX}/reads_1.fq", "-2", str(short), "-S",
                      str(tmp_path / "o.tsv"), "--report-file", ""], capsys)
    assert rc == 1
    assert "fewer reads in file specified with -2" in err
