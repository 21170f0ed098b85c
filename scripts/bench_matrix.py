"""Full reference benchmark matrix on one GPU + max-size discovery.

The analog of the reference's recorded per-node-count scaling tables
(reference: bench_all_ls.py:365-494 pins the max problem size per node count
and sweeps dims 1-4 x {CG, BiCGStab, GMRES(10)}).  This runs the same 12
configurations on the attached GPU at a fixed comparison size (n ~= 16.7M,
f32) via the BenchmarkStencil-equivalent CLI, then discovers the max CG
problem size per dim by doubling until the device runs out of memory, and
can write the results table to a markdown file.

Every configuration (and the bandwidth probe) runs in its own child
process, one at a time: one JAX process holds the card, and this parent
never imports JAX.

Usage:
  python scripts/bench_matrix.py            # 12-config matrix
  python scripts/bench_matrix.py --maxsize  # matrix, THEN max-size discovery
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# (dim, -nx -ny -nz args) at n ~= 16.7M for every dim
SHAPES = {
    1: ["-nx", str(1 << 24)],
    2: ["-nx", "4096", "-ny", "4096"],
    3: ["-nx", "256", "-ny", "256", "-nz", "256"],
    4: ["-nx", "256", "-ny", "256", "-nz", "256"],
}

SOLVER_NAMES = {1: "CG", 2: "BiCGStab", 3: "GMRES(10)"}

_BW = [None]  # parent-measured stream bandwidth, forwarded to subprocesses


def run_config(argv, timeout=1500):
    """One benchmark config in its OWN subprocess, so a config that runs
    out of device memory cannot take the rest of the sweep with it."""
    import subprocess

    env = dict(os.environ, LEGIONSOLVERS_BENCH_JSON="1")
    if _BW[0] is not None and "--bw" not in argv:
        argv = argv + ["--bw", str(_BW[0])]
    proc = subprocess.run(
        [sys.executable, "-m", "legionsolvers_tpu.benchmark"] + argv,
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=os.path.join(os.path.dirname(__file__), ".."),
    )
    for line in proc.stdout.splitlines():
        if line.startswith("BENCH_JSON "):
            return json.loads(line[len("BENCH_JSON "):]), None
    lines = (proc.stderr or proc.stdout or "").strip().splitlines()
    errs = [l for l in lines
            if "Error" in l or "RESOURCE" in l or "INTERNAL" in l]
    tail = errs[-1] if errs else " | ".join(lines[-3:])
    return None, tail[:300] or f"rc={proc.returncode}"


def run_matrix(bw, iters=100):
    rows = []
    for dim in (1, 2, 3, 4):
        for solver in (1, 2, 3):
            it = max(iters // 10, 5) if solver == 3 else iters
            argv = ["-dim", str(dim), "-solver", str(solver),
                    "-it", str(it)] + SHAPES[dim]
            print(f"[matrix] running dim={dim} solver={solver}", flush=True)
            try:
                row, err = run_config(argv)
            except Exception as e:
                row, err = None, f"{type(e).__name__}: {str(e)[:200]}"
            if row is None:
                print(f"[matrix] FAILED dim={dim} solver={solver}: {err}",
                      flush=True)
                row = {"dim": dim, "solver": SOLVER_NAMES[solver],
                       "error": err}
            rows.append(row)
            print(json.dumps(rows[-1]), flush=True)
    return rows


def discover_max_size(bw):
    """Double the 1-chip CG problem size per dim until allocation fails
    (analog of the reference's recorded max sizes, bench_all_ls.py:366-379).
    Each attempt runs in its own subprocess: an OOM must not poison the
    sweep (round-3 finding: it killed every later dim's ladder)."""

    # start sizes chosen ~1/4 of the expected ceiling; shapes double by dim.
    # --consume-rhs = the 3-live-vector CG mode (b donated through r,
    # re-filled between runs): 3 x 4 GB at 2^30 fits the 16 GB HBM,
    # matching the reference's 1-node 1-D/2-D max (bench_all_ls.py:366-379)
    # on 1/4 the memory.
    ladders = {
        1: [["-nx", str(1 << k)] for k in range(28, 32)],
        2: [["-nx", "16384", "-ny", "16384"],
            ["-nx", "32768", "-ny", "16384"],
            ["-nx", "32768", "-ny", "32768"]],
        3: [["-nx", "1024", "-ny", "512", "-nz", "512"],
            ["-nx", "1024", "-ny", "1024", "-nz", "512"],
            ["-nx", "1024", "-ny", "1024", "-nz", "1024"]],
        4: [["-nx", "1024", "-ny", "512", "-nz", "512"],
            ["-nx", "1024", "-ny", "1024", "-nz", "512"],
            ["-nx", "1024", "-ny", "1024", "-nz", "1024"]],
    }
    results = {}
    for dim, ladder in ladders.items():
        best = None
        for shape_args in ladder:
            argv = ["-dim", str(dim), "-solver", "1", "-it", "20",
                    "--consume-rhs"] + shape_args
            try:
                r, err = run_config(argv, timeout=2400)
            except Exception as e:
                r, err = None, f"{type(e).__name__}: {str(e)[:200]}"
            if r is not None:
                best = r
                print(f"[maxsize] dim={dim} ok at n={r['n']}", flush=True)
            else:
                print(f"[maxsize] dim={dim} failed at {shape_args}: {err}",
                      flush=True)
                break
        results[dim] = best
        print(json.dumps({"dim": dim, "max": best}), flush=True)
    return results


def write_results(rows, maxsizes, bw, path):
    """Render the recorded benchmark tables (the analog of the reference's
    committed per-node scaling tables, bench_all_ls.py:365-494)."""
    from legionsolvers_tpu.benchmark import card_line

    dev = next((r["device"] for r in rows if "device" in r), None)
    lines = [
        "# Recorded single-GPU benchmark results",
        "",
        f"Device: {dev}; card: {card_line()}; measured stream roofline "
        f"{bw/1e9:.0f} GB/s." if bw else f"Device: {dev}; card: {card_line()}.",
        "",
        "Machine-generated by `scripts/bench_matrix.py` (matrix-free stencil "
        "operators, f32, fixed-iteration marginal timing — the "
        "BenchmarkStencil metric, reference: test/BenchmarkStencil.cpp:255-262).",
        "",
        "## Solver x dimension matrix (n ~= 16.7M)",
        "",
        "| dim | stencil | solver | n | ms/iter | Gnnz/s | schedule | % roofline |",
        "|---|---|---|---|---|---|---|---|",
    ]
    stencils = {1: "1-D 3-pt", 2: "2-D 5-pt", 3: "3-D 7-pt", 4: "3-D 27-pt"}
    for r in rows:
        if "error" in r:
            lines.append(
                f"| {r['dim']} | {stencils[r['dim']]} | {r['solver']} | - | "
                f"FAILED ({r['error']}) | - | - | - |")
            continue
        pct = f"{r['pct_roofline']:.1f}%" if r.get("pct_roofline") else "-"
        lines.append(
            f"| {r['dim']} | {stencils[r['dim']]} | {r['solver']} | "
            f"{r['n']:,} | {r['ms_per_iter']:.3f} | {r['gnnz_per_s']:.1f} | "
            f"{r['schedule']} | {pct} |")
    if maxsizes:
        lines += [
            "",
            "## Max CG problem size per dim (one GPU, f32)",
            "",
            "| dim | stencil | max n | ms/iter | Gnnz/s |",
            "|---|---|---|---|---|",
        ]
        for dim, r in sorted(maxsizes.items()):
            if r is None:
                lines.append(f"| {dim} | {stencils[dim]} | - | - | - |")
            else:
                lines.append(
                    f"| {dim} | {stencils[dim]} | {r['n']:,} | "
                    f"{r['ms_per_iter']:.3f} | {r['gnnz_per_s']:.1f} |")
    lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    print(f"[matrix] wrote {path}", flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--maxsize", action="store_true",
                   help="also run max-size discovery")
    p.add_argument("--maxsize-only", action="store_true",
                   help="skip the 12-config matrix, run only the ladder")
    p.add_argument("--no-probe", action="store_true")
    p.add_argument("--out", default=None,
                   help="write the results table (markdown) here")
    args = p.parse_args()

    bw = None
    if not args.no_probe:
        import subprocess

        proc = subprocess.run(
            [sys.executable, "-c",
             "from legionsolvers_tpu.utils.timing import "
             "measure_stream_bandwidth as m; print(m())"],
            capture_output=True, text=True, check=True,
            cwd=os.path.join(os.path.dirname(__file__), ".."),
        )
        bw = float(proc.stdout.strip().splitlines()[-1])
        print(f"[matrix] stream bandwidth {bw/1e9:.0f} GB/s", flush=True)
    _BW[0] = bw

    rows = [] if args.maxsize_only else run_matrix(bw)
    maxsizes = (discover_max_size(bw)
                if (args.maxsize or args.maxsize_only) else None)
    if args.out and rows:
        write_results(rows, maxsizes, bw, args.out)


if __name__ == "__main__":
    main()
