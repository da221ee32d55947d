"""What a ``chip_smoke.py`` rank pays before its work, on the card's host:
the import of ``chip_smoke`` (and so of torch) in a fresh interpreter, then
ranks started by ``parallel.launch.run_ranks`` (forked from its fork
server; each rank: CUDA's start and gloo's rendezvous), and ranks whose
argument is 7 GB of host tensors (moved into shared memory).

    python tools/torch_spawn_probe.py        # needs the card
"""
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_IMPORT0 = time.time()
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402,F401  (what every rank imports)
T_IMPORT1 = time.time()

import torch  # noqa: E402
from petastorm_tpu_torch.parallel import launch  # noqa: E402


def _noop_rank(rank, world, t_start):
    t0 = time.time()
    x = torch.ones(4, device="cuda")
    torch.distributed.all_reduce(x)
    return {"enter_s": round(t0 - t_start, 3), "cuda_and_reduce_s": round(time.time() - t0, 3),
            "import_s": round(T_IMPORT1 - T_IMPORT0, 3), "sum": float(x.sum())}


def _arg_rank(rank, world, t_start, blob):
    return {"enter_s": round(time.time() - t_start, 3), "numel": int(blob.numel())}


def _timed(fn, world, *args):
    t = time.time()
    res = launch.run_ranks(fn, world, args=(t, *args), device="cuda")
    return round(time.time() - t, 2), res


if __name__ == "__main__":
    out = subprocess.run([sys.executable, "-X", "importtime", "-c", "import chip_smoke"],
                         capture_output=True, text=True, cwd=REPO)
    rows = [line for line in out.stderr.splitlines()
            if "|" in line and line.split("|")[1].strip().isdigit()]
    rows.sort(key=lambda line: -int(line.split("|")[1]))
    print("import chip_smoke in a fresh interpreter, largest cumulative us:\n"
          + "\n".join(rows[:6]))
    print(f"this process's import of chip_smoke: {T_IMPORT1 - T_IMPORT0:.2f} s")
    for world in (2, 4, 2):
        seconds, res = _timed(_noop_rank, world)
        print(f"{world} ranks: {seconds} s; {res}")
    blob = torch.ones(int(7e9) // 4)
    for label in ("7 GB host argument", "the same argument, already shared"):
        seconds, res = _timed(_arg_rank, 2, blob)
        print(f"2 ranks, {label}: {seconds} s; {res}")
