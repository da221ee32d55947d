"""Start a function in a fresh Python interpreter (never a fork).

A forked child would inherit the parent's CUDA context and its threads
(the loader's, PyTorch's), which is undefined behaviour. The function and
its arguments are pickled by reference onto the child's standard input; the
child is ``python -m petastorm_tpu_torch.workers_pool.exec_in_new_process_entrypoint``.
Two settings of the child's environment:

* ``CUDA_VISIBLE_DEVICES=""``: a worker cannot open a CUDA context, which
  would cost it hundreds of MB of device memory and seconds of start-up;
* the directory that holds ``petastorm_tpu_torch`` goes first on
  ``PYTHONPATH``: the package is not installed, and the child may start in
  another working directory.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

#: The directory that holds the ``petastorm_tpu_torch`` package.
PACKAGE_ROOT = str(Path(__file__).resolve().parent.parent.parent)


def worker_environment() -> dict:
    """The environment of a spawned worker: the parent's, with no visible
    CUDA device and the package's root first on ``PYTHONPATH``."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
    return env


def exec_in_new_process(func, *args, pass_fds=(), **kwargs) -> subprocess.Popen:
    """Run ``func(*args, **kwargs)`` in a new interpreter and return its
    ``Popen``. ``func`` and the arguments must pickle (functions and classes
    by reference); ``pass_fds`` are file descriptors the child inherits."""
    payload = pickle.dumps((func, args, kwargs), protocol=pickle.HIGHEST_PROTOCOL)
    proc = subprocess.Popen(
        [sys.executable, "-m", "petastorm_tpu_torch.workers_pool.exec_in_new_process_entrypoint"],
        stdin=subprocess.PIPE, env=worker_environment(), pass_fds=tuple(pass_fds))
    proc.stdin.write(payload)
    proc.stdin.close()
    return proc
