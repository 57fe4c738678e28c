"""`centrifuge-download` CLI (the reference's Bash script, :1-392).

Fetches NCBI reference genomes / taxonomy dumps / contaminant sets and
emits the seqID-to-taxID map on stdout. Network access may be
unavailable in sandboxed environments; the command surface and URL
construction follow the reference so it works wherever egress exists.
"""

from __future__ import annotations

import argparse
import gzip
import io
import os
import sys
import urllib.request
from typing import List

NCBI = "https://ftp.ncbi.nlm.nih.gov"

DOMAINS = ("bacteria", "viral", "archaea", "fungi", "protozoa",
           "invertebrate", "plant", "vertebrate_mammalian",
           "vertebrate_other")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="centrifuge-download", allow_abbrev=False)
    p.add_argument("database", choices=["refseq", "genbank", "taxonomy",
                                        "contaminants"],
                   help="What to download")
    p.add_argument("-o", dest="outdir", default="./", metavar="<dir>",
                   help="Output directory")
    p.add_argument("-d", dest="domains", default="bacteria",
                   metavar="<domains>",
                   help="Comma-separated domains (refseq/genbank)")
    p.add_argument("-a", dest="assembly_level", default="Complete Genome",
                   metavar="<level>", help="Assembly level filter")
    p.add_argument("-c", dest="refseq_category", default="any",
                   metavar="<category>")
    p.add_argument("-t", dest="taxids", default="", metavar="<taxids>",
                   help="Only download the specified taxonomy IDs")
    p.add_argument("-r", dest="rna", action="store_true",
                   help="Download RNA sequences instead")
    p.add_argument("-u", dest="unmasked", action="store_true",
                   help="Do not dust-mask low-complexity regions")
    p.add_argument("-m", dest="mask", action="store_true",
                   help="Mask low-complexity regions (needs dustmasker)")
    p.add_argument("-l", dest="modify_header", action="store_true",
                   help="Modify header to include taxID")
    p.add_argument("-g", dest="download_gi", action="store_true",
                   help="Also map GIs (legacy)")
    p.add_argument("-P", dest="threads", type=int, default=1,
                   metavar="<num>")
    p.add_argument("-v", dest="verbose", action="store_true")
    return p


def _fetch(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.read()


def _download_taxonomy(outdir: str) -> None:
    os.makedirs(outdir, exist_ok=True)
    url = f"{NCBI}/pub/taxonomy/taxdump.tar.gz"
    print(f"Downloading {url} ...", file=sys.stderr)
    data = _fetch(url)
    import tarfile
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tf:
        for member in ("nodes.dmp", "names.dmp"):
            tf.extract(member, outdir)
    print(f"Extracted nodes.dmp, names.dmp to {outdir}", file=sys.stderr)


def _download_genomes(db: str, args) -> None:
    taxid_filter = set(int(t) for t in args.taxids.split(",") if t)
    for domain in args.domains.split(","):
        if domain not in DOMAINS:
            print(f"Warning: unknown domain {domain}", file=sys.stderr)
            continue
        summary_url = (f"{NCBI}/genomes/{db}/{domain}/assembly_summary.txt")
        print(f"Fetching {summary_url} ...", file=sys.stderr)
        summary = _fetch(summary_url).decode()
        outdir = os.path.join(args.outdir, f"{db}-{domain}")
        os.makedirs(outdir, exist_ok=True)
        for line in summary.splitlines():
            if line.startswith("#"):
                continue
            f = line.split("\t")
            if len(f) < 20:
                continue
            (acc, _, _, category, taxid, species_taxid) = (
                f[0], f[1], f[2], f[4], f[5], f[6])
            level, ftp_path = f[11], f[19]
            if (args.assembly_level != "Any"
                    and level != args.assembly_level):
                continue
            if (args.refseq_category != "any"
                    and category != args.refseq_category):
                continue
            if taxid_filter and int(taxid) not in taxid_filter:
                continue
            if not ftp_path or ftp_path == "na":
                continue
            stem = ftp_path.rsplit("/", 1)[-1]
            suffix = "_rna_from_genomic" if args.rna else "_genomic"
            url = (ftp_path.replace("ftp://", "https://")
                   + f"/{stem}{suffix}.fna.gz")
            dest = os.path.join(outdir, f"{stem}{suffix}.fna")
            try:
                raw = gzip.decompress(_fetch(url))
            except Exception as e:  # noqa: BLE001 - per-file fetch errors
                print(f"Warning: failed {url}: {e}", file=sys.stderr)
                continue
            with open(dest, "wb") as out:
                out.write(raw)
            # emit seqID -> taxID map rows on stdout
            for bline in raw.split(b"\n"):
                if bline.startswith(b">"):
                    seqid = bline[1:].split()[0].decode()
                    sys.stdout.write(f"{seqid}\t{taxid}\n")


def run(argv: List[str]) -> int:
    args = make_parser().parse_args(argv)
    if args.database == "taxonomy":
        _download_taxonomy(args.outdir)
    elif args.database in ("refseq", "genbank"):
        _download_genomes(args.database, args)
    elif args.database == "contaminants":
        os.makedirs(args.outdir, exist_ok=True)
        for name, url in (
                ("UniVec", f"{NCBI}/pub/UniVec/UniVec"),
                ("EmVec", "ftp://ftp.ebi.ac.uk/pub/databases/emvec/emvec.dat.gz")):
            try:
                data = _fetch(url.replace("ftp://", "https://"))
                with open(os.path.join(args.outdir, name + ".fa"), "wb") as f:
                    f.write(data)
            except Exception as e:  # noqa: BLE001
                print(f"Warning: failed {url}: {e}", file=sys.stderr)
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))
