"""Phase 27 of chip_smoke.py alone, on one card: the probe, the kernels'
build beside the writing of phase 27's store, then the phase twice (the
first run pays the card's first ResNet-50 allocation and cuDNN set-up).

    python3 tools/torch_phase27_probe.py
"""
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    smi = cs.phase_probe()
    with tempfile.TemporaryDirectory() as src, ThreadPoolExecutor(1) as writer:
        written = writer.submit(cs.write_live_store, src)
        cs.phase_build()
        for run in range(2):
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                out = cs.phase_live_data(smi, src, written, tmp)
            print("phase 27 run", run, round(time.perf_counter() - t0, 1), out, flush=True)
