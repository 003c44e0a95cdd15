"""``python -m dfac_tpu_torch.cli.data_tools <subcommand>`` — data forensics CLI.

Counterpart of :mod:`dfac_tpu.cli.data_tools`, with the same subcommands
and output lines (reference ``scripts/``):

* ``analyze-pickles``  — pickle bytecode forensics via ``pickletools.genops``
  (protocol, GLOBAL imports, dtype signature strings), for debugging
  library-version mismatches (``scripts/analyze_pickles.py:10-61``);
* ``check-shape``      — features.pkl cell type/shape probe
  (``scripts/check_shape.py``);
* ``score-distributions`` — percentile/fraction CSV for prediction files
  (``scripts/score_distributions.py``);
* ``submission-stats`` — class balance of a submission at 0.5
  (``scripts/pred.py``);
* ``convert-to-npy``   — features.pkl (+ labels.pkl) to the memory-mapped
  ``.npy`` store that both packages read (:mod:`dfac_tpu_torch.io.npy_store`).

The JAX package reads pickles without torch; the port has torch, so it
reads them with pandas, and a ``torch.Tensor`` cell is shown as the numpy
array it holds, as the JAX reader returns it.
"""

from __future__ import annotations

import argparse
import os
import pickletools

INTERESTING_STRINGS = {
    "numpy", "pandas",
    "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64",
    "float16", "float32", "float64",
    "complex64", "complex128",
    "bool", "object", "O8", "<i8", "<f8", "|O8",
    "StringDtype", "StringArray", "ArrowStringArray",
    "category", "datetime64", "timedelta64", "string",
    "torch", "FloatStorage", "DoubleStorage",
}


def analyze_pickle_bytecode(filepath: str) -> dict:
    """Protocol / GLOBAL imports / dtype-signature strings of a pickle."""
    stats: dict = {"globals": set(), "dtypes": set(), "protocol": None, "n_ops": 0}
    last_strings: list[str | None] = [None, None]
    try:
        with open(filepath, "rb") as f:
            for opcode, arg, _pos in pickletools.genops(f):
                stats["n_ops"] += 1
                if opcode.name == "PROTO":
                    stats["protocol"] = arg
                elif opcode.name == "GLOBAL":
                    stats["globals"].add(str(arg))
                elif opcode.name == "STACK_GLOBAL":
                    if last_strings[0] and last_strings[1]:
                        stats["globals"].add(f"{last_strings[0]} {last_strings[1]}")
                elif opcode.name in (
                    "SHORT_BINSTRING", "BINSTRING", "BINUNICODE", "SHORT_BINUNICODE", "UNICODE"
                ):
                    if isinstance(arg, str):
                        last_strings.pop(0)
                        last_strings.append(arg)
                        if arg in INTERESTING_STRINGS:
                            stats["dtypes"].add(arg)
    except Exception as e:  # report, don't crash: forensic tool
        stats["error"] = str(e)
    return stats


def _cmd_analyze(paths: list[str]) -> None:
    import pandas as pd

    for path in paths:
        print(f"\n{'=' * 60}\nREPORT: {os.path.basename(path)}\n{'=' * 60}")
        stats = analyze_pickle_bytecode(path)
        if "error" in stats:
            print(f"  bytecode error: {stats['error']}")
            continue
        print(f"  protocol: {stats['protocol']}   opcodes: {stats['n_ops']}")
        print(f"  globals:  {', '.join(sorted(stats['globals'])) or '(none)'}")
        print(f"  dtypes:   {', '.join(sorted(stats['dtypes'])) or '(none)'}")
        try:
            obj = pd.read_pickle(path)
            if hasattr(obj, "columns"):
                print(f"  loaded DataFrame: columns={list(obj.columns)} rows={len(obj)}")
        except Exception as e:
            print(f"  load failed: {e}")


def _cmd_check_shape(path: str) -> None:
    import pandas as pd

    from dfac_tpu_torch.io.pickle_io import _cell_to_numpy

    df = pd.read_pickle(path)
    print("Columns:", list(df.columns))
    cell = _cell_to_numpy(df.iloc[0]["features"])
    print(f"Type: {type(cell).__name__}")
    print(f"Shape: {getattr(cell, 'shape', None)}")
    print(f"Dtype: {getattr(cell, 'dtype', None)}")


def _cmd_score_distributions(paths: list[str]) -> None:
    import numpy as np

    from dfac_tpu_torch.io.pickle_io import load_predictions

    print(
        "name,rows,min,p01,p05,p10,p25,p50,p75,p90,p95,p99,max,"
        "frac_lt_0.01,frac_gt_0.99,frac_mid_0.1_0.9"
    )
    for path in paths:
        _, s = load_predictions(path)
        q = np.quantile(s, [0.01, 0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99])
        print(
            f"{path},{s.shape[0]},{s.min():.6g},"
            + ",".join(f"{v:.6g}" for v in q)
            + f",{s.max():.6g},{(s < 0.01).mean():.3f},{(s > 0.99).mean():.3f},"
            f"{((s >= 0.1) & (s <= 0.9)).mean():.3f}"
        )


def _cmd_submission_stats(path: str, threshold: float) -> None:
    from dfac_tpu_torch.io.submission import submission_class_counts

    n1, n0 = submission_class_counts(path, threshold)
    print(f"Class 1 count: {n1}")
    print(f"Class 0 count: {n0}")


def main(argv=None):
    p = argparse.ArgumentParser(description="Data forensics tools.")
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("analyze-pickles", help="pickle bytecode analysis")
    a.add_argument("paths", nargs="+")

    c = sub.add_parser("check-shape", help="features.pkl shape probe")
    c.add_argument("path")

    s = sub.add_parser("score-distributions", help="prediction score summary CSV")
    s.add_argument("paths", nargs="+")

    t = sub.add_parser("submission-stats", help="submission class balance")
    t.add_argument("path")
    t.add_argument("--threshold", type=float, default=0.5)

    v = sub.add_parser(
        "convert-to-npy",
        help="convert features.pkl (+labels.pkl) to a memory-mapped .npy "
        "store directory; every CLI then accepts the directory in place of "
        "the pickle and streams batches with O(batch) resident memory",
    )
    v.add_argument("features")
    v.add_argument("out_dir")
    v.add_argument("--labels", default=None)
    v.add_argument("--filter-label", type=int, default=None, metavar="L",
                   help="keep only rows with this label (e.g. 1 for a "
                        "bonafide-only CAE store): filtering at conversion "
                        "keeps the store memory-mapped end to end")

    args = p.parse_args(argv)
    if args.cmd == "analyze-pickles":
        _cmd_analyze(args.paths)
    elif args.cmd == "check-shape":
        _cmd_check_shape(args.path)
    elif args.cmd == "score-distributions":
        _cmd_score_distributions(args.paths)
    elif args.cmd == "submission-stats":
        _cmd_submission_stats(args.path, args.threshold)
    elif args.cmd == "convert-to-npy":
        from dfac_tpu_torch.data.pipeline import load_dataset
        from dfac_tpu_torch.io.npy_store import save_npy_dataset

        if args.filter_label is not None and args.labels is None:
            p.error("--filter-label requires --labels")
        ds = load_dataset(args.features, args.labels)
        if args.filter_label is not None:
            n_before = len(ds)
            ds = ds.filter_label(args.filter_label)
            print(f"label filter {args.filter_label}: kept {len(ds)}/{n_before} rows")
        save_npy_dataset(ds, args.out_dir)
        print(
            f"wrote {len(ds)} utterances "
            f"({'labeled' if ds.labels is not None else 'unlabeled'}) -> {args.out_dir}"
        )


if __name__ == "__main__":
    main()
