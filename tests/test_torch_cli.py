"""The port's tool surface (`python -m centrifuge_tpu_torch <tool>`) against
the JAX package's tools on the same inputs and against the reference
goldens of tests/test_cli.py. Every tool runs in this process through
its `run(argv)` (the port's through its __main__ table); no subprocess
imports jax. Text outputs: byte equality."""

import contextlib
import gzip
import importlib
import io
import os
import sqlite3
import sys
import tarfile

import pytest

from conftest import fixture_path
from test_torch_twin import one_torch_thread  # noqa: F401

FX = fixture_path("synth")
SYN = os.path.join(FX, "synth")


def _f(name: str) -> str:
    return os.path.join(FX, name)


def port_run(argv, monkeypatch=None, stdin=None):
    """(exit code, stdout) of `python -m centrifuge_tpu_torch argv`, run in
    this process through the port's __main__ dispatch."""
    from centrifuge_tpu_torch.__main__ import run
    return _capture(lambda: run(argv), monkeypatch, stdin)


def jax_run(argv, monkeypatch=None, stdin=None):
    """(exit code, stdout) of the JAX package's tool for argv, found in its
    __main__ table."""
    from centrifuge_tpu.__main__ import _TOOLS
    mod, fn = _TOOLS[argv[0]]
    tool = getattr(importlib.import_module(mod), fn)
    return _capture(lambda: tool(argv[1:]), monkeypatch, stdin)


def _capture(call, monkeypatch, stdin):
    if stdin is not None:
        with open(_f(stdin)) as f:
            monkeypatch.setattr(sys, "stdin", io.StringIO(f.read()))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = call()
    return rc, out.getvalue()


def _wrap_60(path: str) -> str:
    """A FASTA file re-wrapped at 60 chars a line: the reference inspect's
    default output for an index of it (test_cli.py
    test_inspect_fasta_byte_parity)."""
    lines, seq = [], []

    def flush():
        s = "".join(seq)
        lines.extend(s[i:i + 60] for i in range(0, len(s), 60))

    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                flush()
                lines.append(line.rstrip("\n"))
                seq = []
            else:
                seq.append(line.strip())
    flush()
    return "\n".join(lines) + "\n"


# (argv, file fed on stdin, golden file)
TOOL_CASES = {
    "kreport_stdin": (["kreport", "-x", SYN], "golden_output.tsv",
                      "golden_kreport.txt"),
    "kreport_k20": (["kreport", "-x", SYN, _f("golden_k20.tsv")], None,
                    "golden_kreport_k20.txt"),
    "kreport_k20_nolca": (["kreport", "-x", SYN, "--no-lca",
                           _f("golden_k20.tsv")], None,
                          "golden_kreport_k20_nolca.txt"),
    "kreport_minscore": (["kreport", "-x", SYN, "--min-score", "1000",
                          _f("golden_output.tsv")], None,
                         "golden_kreport_minscore.txt"),
    "kreport_count_table": (["kreport", "-x", SYN, "--is-count-table"],
                            "counts.tsv", "golden_kreport_counts.txt"),
    "inspect_names": (["inspect", "-n", SYN], None,
                      "inspect/golden_names.txt"),
    "inspect_summary": (["inspect", "-s", SYN], None,
                        "inspect/golden_summary.txt"),
    "inspect_conversion_table": (["inspect", "--conversion-table", SYN],
                                 None, "inspect/golden_conv.txt"),
    "inspect_taxonomy_tree": (["inspect", "--taxonomy-tree", SYN], None,
                              "inspect/golden_tree.txt"),
    "inspect_name_table": (["inspect", "--name-table", SYN], None,
                           "inspect/golden_nametab.txt"),
    "inspect_size_table": (["inspect", "--size-table", SYN], None,
                           "inspect/golden_sizetab.txt"),
    "promote_species": (["promote", SYN, _f("golden_output.tsv"),
                         "species"], None, "golden_promote_species.tsv"),
    "promote_lca": (["promote", SYN, _f("golden_k20.tsv"), "lca"], None,
                    "golden_promote_lca.tsv"),
}


@pytest.mark.parametrize("case", list(TOOL_CASES))
def test_tool_matches_jax_and_golden(case, monkeypatch):
    argv, stdin, golden = TOOL_CASES[case]
    rc, got = port_run(argv, monkeypatch, stdin)
    assert rc == 0
    with open(_f(golden)) as f:
        assert got == f.read()
    assert jax_run(argv, monkeypatch, stdin) == (0, got)


def test_promote_genus_from_stdin_matches_jax(monkeypatch):
    """No reference golden for genus: the port equals the JAX tool, and
    every species taxID (1000+) is promoted (test_cli.py
    test_promote_cli's rule)."""
    argv = ["promote", SYN, "-", "genus"]
    rc, got = port_run(argv, monkeypatch, "golden_output.tsv")
    assert rc == 0
    lines = got.splitlines()
    assert lines[0].startswith("readID") and len(lines) > 1
    for line in lines[1:]:
        tid = int(line.split("\t")[2])
        assert tid < 1000 or tid in (0, 1) or tid >= 10
    assert jax_run(argv, monkeypatch, "golden_output.tsv") == (0, got)


def build_argv(fasta: str, base: str):
    return ["build", "--conversion-table", _f("conv.dmp"), "--taxonomy-tree",
            _f("nodes.dmp"), "--name-table", _f("names.dmp"), "-q", fasta,
            base]


def test_build_is_byte_equal_to_the_fixture_index(tmp_path):
    """The synth fixture's .cf files are the JAX builder's output
    (tests/test_cli.py test_build_cli)."""
    base = str(tmp_path / "idx")
    assert port_run(build_argv(_f("db.fa"), base))[0] == 0
    for ext in ("1", "2", "3", "4"):
        with open(f"{base}.{ext}.cf", "rb") as a, \
                open(f"{SYN}.{ext}.cf", "rb") as b:
            assert a.read() == b.read(), f"{ext}.cf differs"


def test_inspect_fasta_round_trip(tmp_path):
    """build, then inspect's FASTA reconstruction (an LF walk over the
    whole BWT, seconds a Mbp): the first two synth genomes back, wrapped
    at 60 chars a line, equal to the JAX tool's."""
    fasta = str(tmp_path / "two.fa")
    with open(_f("db.fa")) as f, open(fasta, "w") as out:
        recs = 0
        for line in f:
            recs += line.startswith(">")
            if recs > 2:
                break
            out.write(line)
    base = str(tmp_path / "two")
    assert port_run(build_argv(fasta, base))[0] == 0
    rc, got = port_run(["inspect", base])
    assert rc == 0
    assert got == _wrap_60(fasta)
    assert jax_run(["inspect", base]) == (0, got)


def test_simulate_classify_evaluate(tmp_path):
    """simulate -> classify on the CPU -> evaluate: the simulated reads
    and truth table byte-equal to the JAX tool's, the evaluation equal to
    the JAX tool's on the same classification, and the SQL row carrying
    the port's version."""
    import centrifuge_tpu_torch
    sims = {}
    for name, run in (("port", port_run), ("jax", jax_run)):
        prefix = str(tmp_path / name)
        rc, _ = run(["simulate", "-x", _f("db.fa"), "--conversion-table",
                     _f("conv.dmp"), "-o", prefix, "--num", "100",
                     "--seed", "3"])
        assert rc == 0
        sims[name] = []
        for ext in (".fq", ".truth"):
            with open(prefix + ext, "rb") as f:
                sims[name].append(f.read())
    assert sims["port"] == sims["jax"]
    prefix = str(tmp_path / "port")
    out = str(tmp_path / "c.tsv")
    rc, _ = port_run(["classify", "-x", SYN, "-U", prefix + ".fq", "-S",
                      out, "--report-file", "", "--device", "cpu"])
    assert rc == 0
    db = str(tmp_path / "eval.sqlite")
    argv = ["evaluate", "-x", SYN, "--truth", prefix + ".truth", out]
    rc, got = port_run(argv + ["--sql-db", db])
    assert rc == 0
    heads = [ln.split("\t")[0] for ln in got.splitlines()]
    assert heads == ["reads", "unclassified", "strain", "species", "genus",
                     "family", "order", "class", "phylum"]
    assert jax_run(argv) == (0, got)
    with sqlite3.connect(db) as con:
        rows = con.execute("SELECT version, numFragments FROM "
                           "Classification").fetchall()
    assert rows == [(centrifuge_tpu_torch.__version__,
                     int(got.split("\t", 1)[1].split("\n", 1)[0]))]


DOWNLOAD_ARGV = [
    ["refseq"],
    ["genbank", "-o", "OUT", "-d", "viral,archaea,nope", "-a", "Any", "-c",
     "representative genome", "-t", "11,12", "-r", "-u", "-l", "-P", "4"],
    ["taxonomy", "-o", "OUT"],
    ["contaminants", "-o", "OUT", "-v"],
]


@pytest.mark.parametrize("argv", DOWNLOAD_ARGV,
                         ids=["refseq", "genbank", "taxonomy",
                              "contaminants"])
def test_download_offline_matches_jax(argv, tmp_path, monkeypatch):
    """download's parser and the URLs it builds, with every fetch served
    from canned bytes (no network): the same parsed options, URLs, stdout
    and files as the JAX tool."""
    import urllib.request

    from centrifuge_tpu.cli import download_cli as jax_dl
    from centrifuge_tpu_torch.cli import download_cli as port_dl

    def no_network(*a, **k):
        raise AssertionError("download tried the network")

    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    monkeypatch.chdir(tmp_path)     # refseq's default output directory
    assert vars(port_dl.make_parser().parse_args(argv)) == \
        vars(jax_dl.make_parser().parse_args(argv))

    def summary(domain):
        # columns 0-19 of assembly_summary.txt: accession, category (4),
        # taxid (5), species taxid (6), assembly level (11), ftp path (19)
        rows = ["# assembly_accession\t..."]
        for k, (cat, tid, level) in enumerate((
                ("representative genome", "11", "Complete Genome"),
                ("na", "12", "Complete Genome"),
                ("representative genome", "13", "Contig"))):
            f = [""] * 20
            f[0], f[4], f[5], f[6], f[11] = f"GCF_{k}", cat, tid, tid, level
            f[19] = f"ftp://host/{domain}/GCF_{k}_asm"
            rows.append("\t".join(f))
        return "\n".join(rows).encode()

    def taxdump():
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tf:
            for name in ("nodes.dmp", "names.dmp"):
                data = f"{name} body\n".encode()
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
        return buf.getvalue()

    outs = {}
    for name, mod in (("port", port_dl), ("jax", jax_dl)):
        urls = []

        def fetch(url, urls=urls):
            urls.append(url)
            if url.endswith("assembly_summary.txt"):
                return summary(url.split("/")[-2])
            if url.endswith(".fna.gz"):
                return gzip.compress(f">{len(urls)} x\nACGT\n".encode())
            if url.endswith("taxdump.tar.gz"):
                return taxdump()
            return b"vector"

        monkeypatch.setattr(mod, "_fetch", fetch)
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            assert mod.run(argv) == 0
        files = {}
        for root, _, fns in os.walk(tmp_path):
            for fn in fns:
                p = os.path.join(root, fn)
                with open(p, "rb") as f:
                    files[os.path.relpath(p, tmp_path)] = f.read()
                os.remove(p)
        outs[name] = (urls, out.getvalue(), files)
    assert outs["port"] == outs["jax"]
    assert outs["port"][0], "no URL was built"


def test_main_table_holds_the_jax_tools(monkeypatch):
    """__main__ dispatches every tool of the JAX package's table to the
    port's module of the same name, classify by default."""
    from centrifuge_tpu.__main__ import _TOOLS as jax_tools
    from centrifuge_tpu_torch import __main__ as main
    assert list(main._TOOLS) == list(jax_tools)
    for tool, (mod, fn) in main._TOOLS.items():
        jmod, jfn = jax_tools[tool]
        assert mod == "centrifuge_tpu_torch" + jmod[len("centrifuge_tpu"):]
        assert fn == jfn
        assert callable(getattr(importlib.import_module(mod), fn))
    from centrifuge_tpu_torch.cli import classify
    monkeypatch.setattr(classify, "run", lambda argv: ("classify", argv))
    assert main.run(["-x", "idx"]) == ("classify", ["-x", "idx"])
    assert main.run(["classify", "-x", "idx"]) == ("classify", ["-x", "idx"])
