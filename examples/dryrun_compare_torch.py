"""The port's dry-run records beside the JAX package's, one markdown row per
cell: each mesh's roofline terms on the H100 (seconds per rank), the
dominant term and the useful-FLOP fraction, then the 256-rank mesh's dot
FLOPs per rank of both packages and their ratio, and the ratio of their
collective bytes per rank (both counted by ``HloAnalysis``'s rule).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro.launch.dryrun --all --mesh single   # the reference's records
  PYTHONPATH=src python examples/dryrun_compare_torch.py [--port results/dryrun_torch] [--ref results/dryrun]
  PYTHONPATH=src python examples/dryrun_compare_torch.py --port AFTER --before BEFORE

Reads both packages' records through ``repro_torch.launch.roofline.load``.
A cell the reference has no record of reads "none" in its columns.  With
``--before`` (the port's records of an earlier tree), a second table gives,
per cell the two trees share and each mesh, the port's dot FLOPs, argument
bytes, collective bytes over "data" and in all, live temp bytes and
dominant term a rank, before and after, and on the 256-rank mesh the dot
FLOPs' ratio to the reference chip's before and after.
"""
import argparse
import os

from repro_torch.launch.roofline import CELL_ORDER, RESULTS_DIR, load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def records(d: str, tag: str) -> dict:
    return {(r["arch"], r["cell"]): r for r in load(tag, d)}


def terms(r) -> str:
    if r is None:
        return "none | none | none"
    t = r["terms_s"]
    return (f"{t['compute']:.3g} / {t['memory']:.3g} / {t['collective']:.3g} | "
            f"{r['dominant']} | {r['useful_flops_frac']:.3f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", default=RESULTS_DIR)
    ap.add_argument("--ref", default=os.path.join(REPO, "results", "dryrun"))
    ap.add_argument("--before", default=None, help="the port's records of an earlier tree")
    args = ap.parse_args(argv)
    pod1, pod2 = records(args.port, "pod1"), records(args.port, "pod2")
    ref = records(args.ref, "pod1")
    print("| arch | cell | pod1 compute / memory / collective s | dominant | useful "
          "| pod2 compute / memory / collective s | dominant | useful "
          "| pod1 dot FLOPs per rank, port | reference | port / reference "
          "| pod1 collective bytes per rank, port / reference |")
    print("|" + "---|" * 12)
    keys = sorted(set(pod1) | set(pod2), key=lambda k: (k[0], CELL_ORDER.index(k[1])))
    for key in keys:
        p, j = pod1.get(key), ref.get(key)
        dot = f"{p['hlo_dot_flops']:.4g}" if p else "none"
        jdot = f"{j['hlo_dot_flops']:.4g}" if j else "none"
        ratio = (f"{p['hlo_dot_flops'] / j['hlo_dot_flops']:.2f}"
                 if p and j and j["hlo_dot_flops"] else "none")
        coll = (f"{p['collectives']['total_bytes'] / j['collectives']['total_bytes']:.3g}"
                if p and j and j["collectives"]["total_bytes"] else "none")
        print(f"| {key[0]} | {key[1]} | {terms(p)} | {terms(pod2.get(key))} "
              f"| {dot} | {jdot} | {ratio} | {coll} |")
    if args.before:
        changes(args.before, {"pod1": pod1, "pod2": pod2}, ref)


def _over_ref(r, j) -> str:
    return f"{r['hlo_dot_flops'] / j['hlo_dot_flops']:.2f}" if j and j["hlo_dot_flops"] else "none"


def changes(before_dir: str, after: dict, ref: dict) -> None:
    """The port's records of an earlier tree beside these: per rank, dot
    FLOPs, argument bytes (parameters, state, batch, cache), collective
    bytes over "data" and in all, the live temp bytes, and the dominant
    term, before -> after (and after / before); on the 256-rank mesh the
    dot FLOPs over the reference chip's (``ref``), before -> after."""
    print()
    print("| arch | cell | mesh | dot FLOPs before -> after | after / before "
          "| over the reference before -> after "
          "| argument bytes before -> after | after / before "
          "| data collective bytes before -> after "
          "| collective bytes before -> after | temp bytes before -> after "
          "| dominant before -> after |")
    print("|" + "---|" * 12)
    for tag in ("pod1", "pod2"):
        before = records(before_dir, tag)
        for key in sorted(set(before) & set(after[tag]),
                          key=lambda k: (k[0], CELL_ORDER.index(k[1]))):
            b, a = before[key], after[tag][key]
            ab, aa = b["memory"]["argument_bytes"], a["memory"]["argument_bytes"]
            cb, ca = (r["collectives"]["by_axis"].get("data", 0) for r in (b, a))
            tb, ta = (r["collectives"]["total_bytes"] for r in (b, a))
            mb, ma = (r["memory"]["temp_bytes"] for r in (b, a))
            j = ref.get(key) if tag == "pod1" else None
            print(f"| {key[0]} | {key[1]} | {tag} | {b['hlo_dot_flops']:.6g} -> "
                  f"{a['hlo_dot_flops']:.6g} | {a['hlo_dot_flops'] / b['hlo_dot_flops']:.4f} "
                  f"| {_over_ref(b, j)} -> {_over_ref(a, j)} "
                  f"| {ab:.6g} -> {aa:.6g} | {aa / ab:.4f} | {cb} -> {ca} "
                  f"| {tb:.6g} -> {ta:.6g} | {mb:.6g} -> {ma:.6g} "
                  f"| {b['dominant']} -> {a['dominant']} |")


if __name__ == "__main__":
    main()
