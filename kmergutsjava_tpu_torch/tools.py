"""User-facing table-building CLI.

The reference ships no way to create its data directory (kmer.table.mem_map
+ function.index live outside the repo, ref data/README.md); this tool
builds one from annotated proteins.

Usage:
  python -m kmergutsjava_tpu_torch.tools build-table -o DATA_DIR \
      --fasta proteins.faa[.gz] [--functions-from-descr | --function NAME] \
      [--load-factor 0.6] [--weight 1.0] [--gz]
  python -m kmergutsjava_tpu_torch.tools check-table DATA_DIR

Function assignment:
  --functions-from-descr : each distinct description becomes a function
                           (the common case for annotated proteomes);
  --function NAME        : single function for every protein;
  default                : one function per protein id.
OTU index defaults to 0 for every protein (override with --otu-mod N to
spread proteins over N pseudo-OTUs for testing).
"""
from __future__ import annotations

import sys
from typing import List, Optional

from .formats.fasta import read_fasta
from .formats.table_tools import signatures_from_proteins, write_data_dir


def build_table_cli(argv: List[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="build-table")
    ap.add_argument("-o", "--out", required=True, help="output data directory")
    ap.add_argument("--fasta", required=True, help="annotated protein FASTA")
    ap.add_argument("--functions-from-descr", action="store_true")
    ap.add_argument("--function", default=None)
    ap.add_argument("--load-factor", type=float, default=0.6)
    ap.add_argument("--weight", type=float, default=1.0)
    ap.add_argument("--otu-mod", type=int, default=1)
    ap.add_argument("--gz", action="store_true")
    args = ap.parse_args(argv)

    functions: List[str] = []
    fn_index = {}

    def fn_id(name: str) -> int:
        if name not in fn_index:
            fn_index[name] = len(functions)
            functions.append(name)
        return fn_index[name]

    triples = []
    for i, rec in enumerate(read_fasta(args.fasta)):
        if args.function is not None:
            f = fn_id(args.function)
        elif args.functions_from_descr:
            f = fn_id(rec.descr or rec.id)
        else:
            f = fn_id(rec.id)
        triples.append((rec.seq, f, i % max(args.otu_mod, 1)))

    sig = signatures_from_proteins(triples, weight=args.weight)
    table = write_data_dir(args.out, sig, functions,
                           load_factor=args.load_factor, gz=args.gz)
    print(f"wrote {args.out}: {len(sig['kmers'])} signatures, "
          f"{len(functions)} functions, numSigs={table.num_sigs}, "
          f"max_probe={table.max_probe}")
    return 0


def check_table_cli(argv: List[str]) -> int:
    """Validate a data directory: header, slot invariants, function index."""
    import argparse

    import numpy as np

    from .formats.function_index import load_function_index
    from .formats.kmer_table import read_table, resolve_table_files

    ap = argparse.ArgumentParser(prog="check-table")
    ap.add_argument("data_dir")
    args = ap.parse_args(argv)
    table_path, func_path = resolve_table_files(args.data_dir)
    table = read_table(table_path)
    problems = []
    if table.truncated:
        problems.append(f"file truncated: {len(table.slots)} of "
                        f"{table.num_sigs} slots present")
    occ = table.occupied
    n_occ = int(occ.sum())
    kmer = table.slots["kmer"][occ]
    if len(kmer) and (kmer < 0).any():
        problems.append("negative k-mer values present")
    home = kmer % np.int64(table.num_sigs)
    pos = np.nonzero(occ)[0]
    before_home = int((pos < home).sum())
    if before_home:
        problems.append(f"{before_home} entries placed before their home "
                        "slot (wrapped table — the streaming reader and "
                        "probe windows will miss them)")
    max_probe = int((pos - home).max()) + 1 if n_occ else 1
    if len(occ) and occ[-1]:
        problems.append("last slot occupied (reference reader can hit EOF "
                        "mid-probe)")
    uniq = len(np.unique(kmer))
    if uniq != n_occ:
        problems.append(f"{n_occ - uniq} duplicate k-mer values")
    functions = load_function_index(func_path)
    fi = table.slots["fi"][occ]
    if len(fi) and (int(fi.max()) >= len(functions) or int(fi.min()) < 0):
        problems.append(f"functionIndex out of range for function.index "
                        f"({len(functions)} entries)")
    load = n_occ / max(table.num_sigs, 1)
    print(f"{table_path}: numSigs={table.num_sigs} occupied={n_occ} "
          f"(load {load:.2f}) max_probe={max_probe} "
          f"functions={len(functions)}")
    if problems:
        for p in problems:
            print("PROBLEM:", p)
        return 1
    print("OK")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "build-table":
        return build_table_cli(rest)
    if cmd == "check-table":
        return check_table_cli(rest)
    print(f"unknown command: {cmd}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
