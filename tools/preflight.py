"""Pre-snapshot gate: bench + default test suite.

Round 2 and round 3 both shipped end-of-round snapshots with a red bench;
this makes "green before snapshot" one command. Run before any end-of-round
commit and paste the outcome lines into the commit message.

  python tools/preflight.py            # bench + sharded pytest
  python tools/preflight.py --quick    # bench only
  python tools/preflight.py --sweep    # additionally gate on the 5-seed
                                       # accuracy sweep (tools/accuracy_sweep)
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(name, cmd, timeout, ok_codes=(0,)):
    t0 = time.time()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
        ok = p.returncode in ok_codes
        tail = (p.stdout + p.stderr).strip().splitlines()[-1:] or [""]
        msg = tail[0][:140]
    except subprocess.TimeoutExpired:
        ok, msg = False, f"timeout after {timeout}s"
    print(f"[preflight] {name}: {'GREEN' if ok else 'RED'} "
          f"({time.time()-t0:.0f}s) {msg}")
    return ok


# The default suite is sharded across SEPARATE pytest processes: a single
# long-lived process accumulates XLA CPU compile-cache state and has been
# observed to SIGSEGV at the tail on small judge boxes (round-4 verdict).
# Heavy integration files get their own processes; everything else runs in
# one "rest" shard (pytest expands the remaining files itself).
HEAVY = [
    "tests/test_tracker.py",
    "tests/test_slam.py",
    "tests/test_pipeline.py tests/test_depth.py",
    "tests/test_mapping.py tests/test_ba.py tests/test_loop_closure.py",
]


def pytest_shards():
    heavy_files = " ".join(HEAVY).split()
    rest = sorted(
        f"tests/{f}" for f in os.listdir(os.path.join(ROOT, "tests"))
        if f.startswith("test_") and f.endswith(".py")
        and f"tests/{f}" not in heavy_files)
    shards = [("pytest-rest", rest)]
    shards += [(f"pytest-{g.split('/')[-1].split('.')[0].replace('test_', '')}",
                g.split()) for g in HEAVY]
    return shards


def main():
    quick = "--quick" in sys.argv
    sweep = "--sweep" in sys.argv
    results = [run("bench", [sys.executable, "bench.py"], 1200)]
    if not quick:
        for name, files in pytest_shards():
            # Exit 5 == no tests selected (a shard whose files are all
            # slow-marked under the default '-m not slow') — not a failure.
            results.append(run(
                name, [sys.executable, "-m", "pytest", *files, "-q",
                       "-x", "-p", "no:cacheprovider"], 2400,
                ok_codes=(0, 5)))
    if sweep:  # non-quick full gate: the 5-seed accuracy sweep must exit 0
        results.append(run(
            "accuracy-sweep", [sys.executable, "tools/accuracy_sweep.py"],
            3600))
    print("[preflight] ALL GREEN" if all(results) else "[preflight] RED")
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
