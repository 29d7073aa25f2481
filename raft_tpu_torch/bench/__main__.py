"""CLI — the raft-ann-bench orchestration analog, counterpart of
``python -m raft_tpu.bench``:

    python -m raft_tpu_torch.bench run --conf config.json [--k 10] ...
    python -m raft_tpu_torch.bench get-dataset --hdf5 glove-100-angular.hdf5 --out data/
    python -m raft_tpu_torch.bench generate-groundtruth --base b.fbin \\
        --queries q.fbin --out gt.ibin
    python -m raft_tpu_torch.bench split-groundtruth --gt combined.fbin --out-prefix gt

``run`` reads a run config, executes every index/search combo, writes
JSON-lines + CSV (+ optional pareto plot), on the card unless ``--device
cpu``. ``get-dataset`` converts a local ann-benchmarks HDF5 file into the
fbin/ibin layout (the reference CLI downloads, then converts; this one
only converts: nothing is downloaded).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _resources(args):
    from raft_tpu_torch.core.resources import Resources

    return Resources(device=args.device or "cuda")


def _cmd_run(args) -> int:
    from raft_tpu_torch.bench import export, runner

    with open(args.conf) as f:
        config = json.load(f)
    if args.scale:
        target = {"chip": 4_000_000, "smoke": 100_000}.get(args.scale)
        if target is None:
            target = int(args.scale)
        config = runner.scale_config(config, target)
    def entry_name(e):
        # the runner itself tolerates a missing "name" via the same
        # fallback (runner.run_benchmark row labeling)
        return e.get("name", e.get("algo", ""))

    if args.algos:
        config["index"] = [
            e for e in config["index"]
            if any(s in entry_name(e) or s in e.get("algo", "")
                   for s in args.algos)]
        print(f"--algos: running {[entry_name(e) for e in config['index']]}")
    prior = []
    if args.resume and args.out and os.path.exists(args.out):
        # skip work already in the out JSONL (the host baselines' rows
        # can be produced apart, and a card run then only pays for the
        # card's algos). Completion is keyed per
        # (name, search_param), not per entry: the runner appends one row
        # per search_param as each completes, so a timeout kill mid-entry
        # leaves a partial entry whose remaining points must still run on
        # the next resume (a name-only key would silently drop them from
        # the pareto front).
        done = set()
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except ValueError:
                    continue
                prior.append(r)
                done.add((r.get("name"),
                          json.dumps(r.get("search_param", {}),
                                     sort_keys=True)))
        kept, skipped, partial = [], [], []
        for e in config["index"]:
            name = entry_name(e)
            sps = e.get("search_params", [{}])
            missing = [sp for sp in sps
                       if (name, json.dumps(sp, sort_keys=True)) not in done]
            if not missing:
                skipped.append(name)
            else:
                if len(missing) < len(sps):
                    partial.append(f"{name} ({len(missing)}/{len(sps)} "
                                   "search params left)")
                kept.append(dict(e, search_params=missing))
        config["index"] = kept
        if skipped:
            print(f"--resume: skipping completed {skipped}")
        if partial:
            print(f"--resume: finishing partial {partial}")
    rows = runner.run_benchmark(config, k=args.k, batch_size=args.batch_size,
                                search_iters=args.iters, out_path=args.out,
                                res=_resources(args))
    for r in rows:
        print(json.dumps(r))
    all_rows = prior + rows  # resumed runs export the full set
    if args.csv:
        export.export_csv(all_rows, args.csv, pareto=args.pareto)
    if args.plot:
        export.plot(all_rows, args.plot)
    return 0


def _cmd_get_dataset(args) -> int:
    """HDF5 (ann-benchmarks layout: train/test/neighbors/distances) → fbin
    files (the get_dataset CLI's hdf5_to_fbin step)."""
    import h5py
    import numpy as np

    from raft_tpu_torch import native

    name = os.path.splitext(os.path.basename(args.hdf5))[0]
    out_dir = os.path.join(args.out, name)
    os.makedirs(out_dir, exist_ok=True)
    with h5py.File(args.hdf5, "r") as f:
        normalize = args.normalize or name.endswith("-angular")
        for key, fname, dt in (("train", "base.fbin", np.float32),
                               ("test", "query.fbin", np.float32),
                               ("neighbors", "groundtruth.neighbors.ibin",
                                np.int32),
                               ("distances", "groundtruth.distances.fbin",
                                np.float32)):
            if key not in f:
                continue
            arr = np.asarray(f[key], dt)
            if normalize and key in ("train", "test"):
                arr = arr / np.maximum(
                    np.linalg.norm(arr, axis=1, keepdims=True), 1e-20)
            native.write_bin(os.path.join(out_dir, fname), arr)
            print(f"wrote {out_dir}/{fname} {arr.shape}")
    return 0


def _cmd_generate_groundtruth(args) -> int:
    import numpy as np

    from raft_tpu_torch import native
    from raft_tpu_torch.bench import runner

    base = native.read_bin(args.base)
    queries = native.read_bin(args.queries)
    gt = runner.generate_groundtruth(base, queries, args.k, args.metric,
                                     res=_resources(args))
    native.write_bin(args.out, np.asarray(gt, np.int32))
    print(f"wrote {args.out} {gt.shape}")
    return 0


def _cmd_split_groundtruth(args) -> int:
    from raft_tpu_torch.bench import runner

    neigh = args.out_prefix + ".neighbors.ibin"
    dist = args.out_prefix + ".distances.fbin"
    runner.split_groundtruth(args.gt, neigh, dist)
    print(f"wrote {neigh}, {dist}")
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # back-compat: `--conf ...` without a subcommand means `run`
    # (but let --help/-h reach the top-level parser so subcommands show)
    if argv and argv[0].startswith("--") and argv[0] not in ("--help",):
        argv = ["run", *argv]

    p = argparse.ArgumentParser(prog="raft_tpu_torch.bench")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run a benchmark config")
    pr.add_argument("--conf", required=True, help="run config JSON path")
    pr.add_argument("--scale", default=None,
                    help="shrink the config to run at reduced scale: "
                         "'chip' (4M rows), 'smoke' (100k), "
                         "or an explicit row count; cluster counts scale "
                         "with the row factor and a synthetic clustered "
                         "dataset stands in for missing files")
    pr.add_argument("--k", type=int, default=10)
    pr.add_argument("--batch-size", type=int, default=None)
    pr.add_argument("--iters", type=int, default=3)
    pr.add_argument("--out", default="bench_results.jsonl")
    pr.add_argument("--csv", default=None)
    pr.add_argument("--plot", default=None)
    pr.add_argument("--pareto", action="store_true")
    pr.add_argument("--algos", nargs="*", default=None,
                    help="only run index entries whose name/algo contains "
                         "one of these substrings")
    pr.add_argument("--resume", action="store_true",
                    help="skip index entries already present in --out")
    pr.add_argument("--device", default=None,
                    help="default: the card (cuda); 'cpu' for a rehearsal")
    pr.set_defaults(fn=_cmd_run)

    pg = sub.add_parser("get-dataset",
                        help="convert a local ann-benchmarks HDF5 to fbin")
    pg.add_argument("--hdf5", required=True)
    pg.add_argument("--out", default="datasets")
    pg.add_argument("--normalize", action="store_true",
                    help="L2-normalize rows (angular datasets)")
    pg.set_defaults(fn=_cmd_get_dataset)

    pq = sub.add_parser("generate-groundtruth",
                        help="exact brute-force ground truth → ibin")
    pq.add_argument("--base", required=True)
    pq.add_argument("--queries", required=True)
    pq.add_argument("--out", required=True)
    pq.add_argument("--k", type=int, default=100)
    pq.add_argument("--metric", default="euclidean")
    pq.add_argument("--device", default=None)
    pq.set_defaults(fn=_cmd_generate_groundtruth)

    ps = sub.add_parser("split-groundtruth",
                        help="split combined gt fbin into neighbors+distances")
    ps.add_argument("--gt", required=True)
    ps.add_argument("--out-prefix", required=True)
    ps.set_defaults(fn=_cmd_split_groundtruth)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
