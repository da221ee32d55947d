"""A short first run of the flash backward kernels on an NVIDIA GPU: the
toolkit's versions, ``ptxas -v`` for every kernel of
``csrc/flash_attn_bwd.cu`` (registers, spills), the wgmma/TMA layout check
of ``tools/torch_wgmma_probe.cu``, K3 and K4 against the plain backward at
small shapes, then at the token path's shape with both routes timed:

    python3 tools/torch_bwd_probe.py

Build outputs go to ``build/probe/``. It stops at the first case that
raises; every reading is printed, nothing is judged."""
import ctypes, os, statistics, subprocess, sys, time, traceback
from pathlib import Path
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import torch
from petastorm_tpu_torch import kernels
from petastorm_tpu_torch.kernels import build as kb
from petastorm_tpu_torch.ops import flash_attn as fa

def log(*a):
    print(*a, flush=True)

log("python", sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda)
log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                   capture_output=True, text=True).stdout.strip())
nvcc = kb.find_nvcc()
log(subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout.strip().splitlines()[-1])
out = ROOT / "build" / "probe"
out.mkdir(parents=True, exist_ok=True)
t0 = time.time()
procs = {
    "ptxas": subprocess.Popen([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                               "-cubin", "-Xptxas", "-v", "-o", str(out / "bwd.cubin"),
                               str(kb.CSRC_DIR / "flash_attn_bwd.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
    "probe": subprocess.Popen([nvcc, *kb.NVCC_FLAGS, "-o", str(out / "probe.so"),
                               str(ROOT / "tools" / "torch_wgmma_probe.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
}
try:
    kb.build(["flash_attn_bwd"])
    log(f"package build ok in {time.time() - t0:.1f} s")
except Exception as e:
    log("package build FAILED:", str(e)[-6000:])
for name, p in procs.items():
    text = p.communicate()[0].decode(errors="replace")
    log(f"--- {name} rc {p.returncode} ({time.time() - t0:.1f} s)")
    keep = [l for l in text.splitlines() if any(w in l for w in ("error", "warning", "Used", "spill", "Compiling", "bytes stack"))]
    log("\n".join(keep[-80:]) if name == "ptxas" else text[-3000:])

# Primitive check.
try:
    lib = ctypes.CDLL(str(out / "probe.so"))
    lib.run_probe.argtypes = [ctypes.c_void_p] * 4
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, 64, 1, 128, generator=g, device="cuda").bfloat16()
    k = torch.randn(1, 64, 1, 128, generator=g, device="cuda").bfloat16()
    s_out = torch.zeros(64, 64, device="cuda"); o_out = torch.zeros(64, 128, device="cuda")
    rc = lib.run_probe(q.data_ptr(), k.data_ptr(), s_out.data_ptr(), o_out.data_ptr())
    torch.cuda.synchronize()
    s_ref = q[0, :, 0].float() @ k[0, :, 0].float().T
    o_ref = s_ref.bfloat16().float() @ k[0, :, 0].float()
    log("probe rc", rc, "S err", (s_out - s_ref).abs().max().item(), "O err", (o_out - o_ref).abs().max().item(),
        "O scale", o_ref.abs().max().item())
    if (s_out - s_ref).abs().max().item() > 1e-2:
        log("S sample got", s_out[:2, :8].tolist()); log("S sample want", s_ref[:2, :8].tolist())
    if (o_out - o_ref).abs().max().item() > 1e-1:
        log("O sample got", o_out[:2, :8].tolist()); log("O sample want", o_ref[:2, :8].tolist())
except Exception:
    log("probe FAILED", traceback.format_exc()[-3000:])

def case(b, sq, sk, h, kv_h, d, causal, dtype, what, strided=False):
    g = torch.Generator(device="cuda").manual_seed(sq * sk + d)
    rn = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    if strided:
        qkv = rn(b, sq, h + 2 * kv_h, d)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv_h], qkv[:, :, h + kv_h:]
    else:
        q, k, v = rn(b, sq, h, d), rn(b, sk, kv_h, d), rn(b, sk, kv_h, d)
    do = rn(b, sq, h, d)
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal)
    kernels.reset_launch_counts()
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    counts = dict(kernels.launch_counts)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    parts = []
    for n, x, y, z in zip("qkv", got, want, again):
        err = (x.float() - y.float()).abs()
        row = y.float().square().mean(-1, keepdim=True).sqrt().clamp_min(2 ** -7 * y.float().square().mean().sqrt().item())
        parts.append(f"d{n} max {err.max().item():.3g} rms/row {(err / row).square().mean().sqrt().item():.3g} "
                     f"worst/row {(err / row).max().item():.3g} eq {torch.equal(x, z)} finite {bool(torch.isfinite(x.float()).all())}")
    log(f"[case] {what}: route {fa.bwd_route(dtype, d)} counts {counts}: " + "; ".join(parts))
    return q, k, v, o, lse, do

cases = [(1, 64, 64, 1, 1, 128, False, torch.bfloat16, "one tile non-causal d128"),
         (1, 128, 128, 2, 1, 64, False, torch.bfloat16, "non-causal d64 rep 2"),
         (1, 256, 256, 4, 2, 128, True, torch.bfloat16, "causal 256 d128"),
         (1, 100, 100, 4, 2, 64, True, torch.bfloat16, "ragged 100 d64 causal"),
         (2, 96, 64, 4, 2, 64, True, torch.bfloat16, "causal sq 96 > sk 64"),
         (2, 40, 130, 4, 1, 64, True, torch.bfloat16, "causal sq 40 < sk 130"),
         (2, 77, 130, 4, 1, 64, False, torch.bfloat16, "non-causal 77 x 130"),
         (2, 200, 200, 4, 4, 128, True, torch.bfloat16, "MHA"),
         (2, 150, 150, 8, 4, 128, False, torch.float16, "f16 non-causal d128"),
         (1, 300, 300, 4, 2, 72, True, torch.bfloat16, "d72"),
         (1, 300, 300, 4, 2, 32, True, torch.float16, "d32 f16"),
         (2, 128, 128, 4, 2, 64, True, torch.bfloat16, "strided qkv", True),
         (1, 1000 - 37, 1000 - 37, 8, 2, 128, True, torch.bfloat16, "963 causal")]
for c in cases:
    try:
        case(*c[:9], strided=len(c) > 9)
    except Exception:
        log("case FAILED", c[8], traceback.format_exc()[-2500:])
        break
else:
    try:
        b, s, h, kv_h, d = 2, 8192, 32, 8, 128
        q, k, v, o, lse, do = case(b, s, s, h, kv_h, d, True, torch.bfloat16, "token shape")
        tc = fa._bwd_inputs(fa.TENSOR_CORES, q, k, v, o, lse, do)
        fm = fa._bwd_inputs(fa.FMA, q, k, v, o, lse, do)
        fns = {"K3 tc": lambda: fa._flash_bwd_dq(fa.TENSOR_CORES, *tc, True),
               "K4 tc": lambda: fa._flash_bwd_dkv(fa.TENSOR_CORES, *tc, True),
               "K3 fma": lambda: fa._flash_bwd_dq(fa.FMA, *fm, True),
               "K4 fma": lambda: fa._flash_bwd_dkv(fa.FMA, *fm, True)}
        for name, fn in fns.items():
            fn(); torch.cuda.synchronize()
            ts = []
            for _ in range(5):
                a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record(); fn(); z.record(); z.synchronize(); ts.append(a.elapsed_time(z))
            ms = statistics.median(ts)
            flops = 2 * b * h * d * s * (s + 1) // 2 * (3 if "K3" in name else 4)
            log(f"[time] {name}: {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s")
    except Exception:
        log("token FAILED", traceback.format_exc()[-2500:])
log("probe done")
