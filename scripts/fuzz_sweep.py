"""Full randomized conformance sweep (the corpus-scale run).

Runs N seeded fuzz cases (default 120) through the oracle chain of
tests/test_fuzz_sweep.py and prints a one-line-per-failure report plus
a summary. Failures reproduce with:

    GRAV1_SWEEP_SEED=<seed> python -m pytest tests/test_fuzz_sweep.py

Budget: ~0.4 s/case on this host (~1 min for 120). Usage:

    python scripts/fuzz_sweep.py [N]
"""

import os
import sys
import time
import traceback

sys.path.insert(0, "tests")
sys.path.insert(0, ".")

# the sweep is a host-side conformance harness: the 8-device virtual
# CPU mesh (as tests/conftest.py sets up), where the device-engine arm
# runs the grain kernels in interpret mode
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

from test_conformance import _encode_case, run_oracle_chain  # noqa: E402
from test_fuzz_sweep import SEED_BASE, gen_case, run_framing_arms  # noqa: E402


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 120
    t0 = time.time()
    failures = []
    for i in range(n):
        seed = SEED_BASE + i
        cfg, grain = gen_case(seed)
        try:
            pkts = _encode_case(
                cfg["w"], cfg["h"], cfg["bd"], cfg["mono"], cfg["n"],
                cfg["opts"], cfg["sub_x"], cfg["sub_y"],
            )
            assert pkts, "no packets"
            # same deterministic arm schedule as the pytest sweep:
            # every 4th case drives the production Pallas kernels,
            # every 3rd the Annex B / Section 5 framing arms
            run_oracle_chain(
                pkts, grain, cfg["n"], cfg["mono"],
                device_engine=(seed % 4 == 0),
            )
            if seed % 3 == 1:
                import pathlib
                import tempfile

                with tempfile.TemporaryDirectory() as td:
                    run_framing_arms(pkts, grain, pathlib.Path(td))
            status = "ok"
        except Exception as e:  # noqa: BLE001 — report and continue
            failures.append((seed, cfg, e))
            status = f"FAIL {type(e).__name__}: {e}"
            traceback.print_exc()
        print(f"[{i + 1:3d}/{n}] seed={seed:#x} "
              f"{cfg['w']}x{cfg['h']}@{cfg['bd']} "
              f"sub={cfg['sub_x']}{cfg['sub_y']}"
              f"{' mono' if cfg['mono'] else ''} n={cfg['n']} "
              f"opts='{cfg['opts']}' -> {status}")
    dt = time.time() - t0
    print(f"\n{n - len(failures)}/{n} passed in {dt:.0f}s")
    for seed, cfg, e in failures:
        print(f"  seed={seed:#x}: {type(e).__name__}: {e}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
