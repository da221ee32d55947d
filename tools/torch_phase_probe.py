"""One phase of chip_smoke.py alone, on one card: the probe, the kernels'
build beside the writing of the phase's store, then the phase twice (the
first run pays the card's first ResNet-50 allocation and cuDNN set-up),
then the card tests of the phase's slice where it names them.

    python3 tools/torch_phase_probe.py 27    # live data
    python3 tools/torch_phase_probe.py 28    # stores in petastorm's format
"""
import argparse
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

def _reference_stores(smi, src, written, tmp):
    written.result()
    return cs.phase_reference_stores(smi, f"file://{src}/imagenet_like", tmp)


#: phase -> (store writer, run(smi, store dir, writer future, tmp), the
#: ``-k`` of its card tests in tests/test_torch_cuda.py or None)
PHASES = {
    27: (cs.write_live_store, cs.phase_live_data, None),
    28: (cs.write_slice_store, _reference_stores, "petastorm"),
}

if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("phase", type=int, choices=sorted(PHASES))
    phase = parser.parse_args().phase
    write, run_phase, card_tests = PHASES[phase]
    smi = cs.phase_probe()
    with tempfile.TemporaryDirectory() as src, ThreadPoolExecutor(1) as writer:
        written = writer.submit(write, src)
        cs.phase_build()
        for run in range(2):
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                out = run_phase(smi, src, written, tmp)
            print(f"phase {phase} run", run, round(time.perf_counter() - t0, 1), out, flush=True)
    if card_tests:
        sys.exit(subprocess.call([sys.executable, "-m", "pytest", "--noconftest", "-p",
                                  "no:cacheprovider", "-q", "tests/test_torch_cuda.py", "-k",
                                  card_tests], cwd=REPO))
