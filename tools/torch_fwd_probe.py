"""A short first run of the flash forward (K2) and normalize (K1) kernels on
an NVIDIA GPU: the toolkit's versions, ``ptxas -v`` for every kernel of
``csrc/flash_attn.cu``, ``csrc/normalize.cu`` and ``csrc/flash_attn_bwd.cu``
(registers, spills, serialised wgmma), K2 on both routes against the plain
version at small shapes, K1 against its plain version at aligned, odd and
misaligned inputs, then the token path's shapes timed in turns. Given the
parent commit's ``csrc/`` unpacked under ``build/parent/`` (``git archive
<parent> petastorm_tpu_torch/csrc | tar -x -C build/parent``), it also
builds that K1 and K3/K4, times K1 against it and checks that K3/K4 give
the parent's bits. K2's "stats" mode is timed against "out" and "lse" at
ring attention's block:

    python3 tools/torch_fwd_probe.py [LOG]

Build outputs go to ``build/probe/``, and everything printed also to LOG
(default ``build/probe/fwd_probe.log``). It stops at the first case that raises;
every reading is printed, nothing is judged."""
import os, statistics, subprocess, sys, time, traceback
from pathlib import Path
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import torch
import torch.nn.functional as F
from petastorm_tpu_torch import kernels
from petastorm_tpu_torch.kernels import build as kb
from petastorm_tpu_torch.ops import flash_attn as fa
from petastorm_tpu_torch.ops.image_ops import normalize_images, normalize_images_plain

_log_path = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "build" / "probe" / "fwd_probe.log"
_log_path.parent.mkdir(parents=True, exist_ok=True)
LOG = open(_log_path, "w")


def log(*a):
    print(*a, flush=True)
    print(*a, file=LOG, flush=True)

log("python", sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda)
log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                   capture_output=True, text=True).stdout.strip())
nvcc = kb.find_nvcc()
log(subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout.strip().splitlines()[-1])
out = ROOT / "build" / "probe"
out.mkdir(parents=True, exist_ok=True)
t0 = time.time()
procs = {name: subprocess.Popen([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                                 "-O3", "-cubin", "-Xptxas", "-v", "-o", str(out / f"{name}.cubin"),
                                 str(kb.CSRC_DIR / f"{name}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
         for name in ("flash_attn", "normalize", "flash_attn_bwd")}
try:
    kb.build(["flash_attn", "normalize", "flash_attn_bwd"])
    log(f"package build ok in {time.time() - t0:.1f} s")
except Exception as e:
    log("package build FAILED:", str(e)[-8000:])
for name, p in procs.items():
    text = p.communicate()[0].decode(errors="replace")
    log(f"--- ptxas {name} rc {p.returncode} ({time.time() - t0:.1f} s)")
    lines = text.splitlines()
    for i, l in enumerate(lines):
        if any(w in l for w in ("error", "warning", "C7513")):
            log(l[:300])
        elif "Compiling entry" in l:   # the kernel, then its stack/spill and register lines
            log(l.split("'")[1][:120], "|", " ".join(x.strip() for x in lines[i + 1:i + 3]))


def median_ms(fns, reps=5):
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for rep in range(reps):
        names = list(fns) if rep % 2 == 0 else list(reversed(fns))
        for name in names:
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record(); fns[name](); z.record(); z.synchronize()
            times[name].append(a.elapsed_time(z))
    return {name: statistics.median(t) for name, t in times.items()}


def fwd_case(b, sq, sk, h, kv_h, d, causal, dtype, what, strided=False):
    g = torch.Generator(device="cuda").manual_seed(sq * sk + d)
    rn = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    if strided:
        qkv = rn(b, sq, h + 2 * kv_h, d)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv_h], qkv[:, :, h + kv_h:]
    else:
        q, k, v = rn(b, sq, h, d), rn(b, sk, kv_h, d), rn(b, sk, kv_h, d)
    kernels.reset_launch_counts()
    o, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    o2 = fa.flash_attention(q, k, v, causal=causal)
    counts = dict(kernels.launch_counts)
    want_o, want_lse = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = (o.float() - want_o.float()).abs()
    row = want_o.float().square().mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    log(f"[fwd] {what}: route {fa.fwd_route(dtype, d)} counts {counts}: o max {err.max().item():.3g} "
        f"worst/row {((err - 2 ** -7 * want_o.float().abs()) / row).max().item():.3g} "
        f"rms/row {(err / row).square().mean().sqrt().item():.3g}; lse max "
        f"{(lse - want_lse).abs().max().item():.3g}; out == lse-mode o {torch.equal(o, o2)}; "
        f"finite {bool(torch.isfinite(o.float()).all())}")
    return q, k, v


def bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def k1_case(shape, dtype, offset=0):
    g = torch.Generator(device="cuda").manual_seed(sum(shape) + offset)
    n = 1
    for s in shape:
        n *= s
    flat = torch.randint(0, 256, (n + offset,), generator=g, device="cuda", dtype=torch.uint8)
    x = flat[offset:].view(shape)
    mean, std = (0.4, 0.5, 0.6, 0.7), (0.2, 0.25, 0.3, 0.35)
    got = normalize_images(x, mean, std, out_dtype=dtype)
    want = normalize_images_plain(x, mean, std, out_dtype=dtype)
    torch.cuda.synchronize()
    log(f"[k1] {shape} {dtype} offset {offset} (data_ptr % 16 = {x.data_ptr() % 16}): "
        f"bit-equal {torch.equal(bits(got), bits(want))}, "
        f"max abs {(got.float() - want.float()).abs().max().item():.3g}")
    return x


try:
    for shape, dtype, offset in [((4, 9, 7, 3), torch.bfloat16, 0), ((3, 17, 19, 3), torch.float32, 0),
                                 ((2, 5, 5, 4), torch.float16, 0), ((16, 224, 224, 1), torch.bfloat16, 0),
                                 ((5, 33, 31, 3), torch.bfloat16, 1), ((5, 33, 31, 3), torch.float32, 7),
                                 ((1, 1, 5, 3), torch.bfloat16, 3), ((256, 224, 224, 3), torch.bfloat16, 0),
                                 ((256, 224, 224, 3), torch.float32, 0), ((8, 224, 224, 3), torch.bfloat16, 5)]:
        x = k1_case(shape, dtype, offset)
    x = k1_case((256, 224, 224, 3), torch.bfloat16)
    ms = median_ms({"kernel": lambda: normalize_images(x), "plain": lambda: normalize_images_plain(x)}, 50)
    log(f"[time] K1 (256,224,224,3) -> bf16: {ms}; bound 0.0345 ms")
except Exception:
    log("k1 FAILED", traceback.format_exc()[-3000:])

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
         (1, 300, 300, 4, 2, 8, True, torch.bfloat16, "d8"),
         (1, 300, 300, 4, 2, 32, True, torch.float16, "d32 f16"),
         (2, 128, 128, 4, 2, 64, True, torch.bfloat16, "strided qkv", True),
         (2, 300, 300, 8, 2, 64, True, torch.float32, "f32 (FMA route)"),
         (1, 70, 70, 2, 1, 256, True, torch.bfloat16, "d256 (FMA route)"),
         (1, 1000 - 37, 1000 - 37, 8, 2, 128, True, torch.bfloat16, "963 causal")]
for c in cases:
    try:
        fwd_case(*c[:9], strided=len(c) > 9)
    except Exception:
        log("case FAILED", c[8], traceback.format_exc()[-2500:])
        break
else:
    try:
        b, s, h, kv_h, d = 2, 8192, 32, 8, 128
        q, k, v = fwd_case(b, s, s, h, kv_h, d, True, torch.bfloat16, "token shape")
        flops = 4 * b * h * d * s * (s + 1) // 2
        ms = median_ms({
            "tc out": lambda: fa._flash_fwd(fa.TENSOR_CORES, q, k, v, True, False),
            "tc lse": lambda: fa._flash_fwd(fa.TENSOR_CORES, q, k, v, True, True),
            "fma out": lambda: fa._flash_fwd(fa.FMA, q, k, v, True, False),
            "sdpa": lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                enable_gqa=True)})
        log("[time] token shape:", {n: f"{t:.4f} ms, {flops / t / 1e9:.1f} TFLOP/s" for n, t in ms.items()})
        a = fa._flash_fwd(fa.TENSOR_CORES, q, k, v, True, True)
        z = fa._flash_fwd(fa.TENSOR_CORES, q, k, v, True, True)
        log("[fwd] two launches equal bits:", torch.equal(a[0], z[0]) and torch.equal(a[1], z[1]))
    except Exception:
        log("token FAILED", traceback.format_exc()[-2500:])


def sleep_ms(fns, reps=20, batch=1):
    """Median CUDA-event time of each of ``fns``, timed in turns, each
    timing started behind a 2 ms device sleep so that the host's
    preparation of the call is not counted; ``batch`` calls per timing."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for rep in range(reps):
        for name in (list(fns) if rep % 2 == 0 else list(reversed(fns))):
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(4_000_000)
            a.record()
            for _ in range(batch):
                fns[name]()
            z.record(); z.synchronize()
            times[name].append(a.elapsed_time(z) / batch)
    return {name: round(statistics.median(t), 5) for name, t in times.items()}


# K2's three modes at the ring's block (1, 4096, 32/8, 128) bf16 on the
# tensor cores: what the "stats" epilogue (o stored in float32, m and l)
# costs against "out" and "lse", causal (the diagonal) and not (a past block).
try:
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(1, 4096, n, 128, generator=g, device="cuda").bfloat16() for n in (32, 8, 8))
    for causal in (True, False):
        log(f"[stats time] ring block, causal={causal}, behind a device sleep:", sleep_ms({
            "out": lambda: fa._flash_fwd(fa.TENSOR_CORES, q, k, v, causal, False),
            "lse": lambda: fa._flash_fwd(fa.TENSOR_CORES, q, k, v, causal, True),
            "stats": lambda: fa._flash_stats_fwd(fa.TENSOR_CORES, q, k, v, causal)}, 20))
except Exception:
    log("stats FAILED", traceback.format_exc()[-2500:])

parent = ROOT / "build" / "parent" / "petastorm_tpu_torch" / "csrc"
if parent.is_dir():
    try:
        libs = {}
        for name in ("normalize", "flash_attn_bwd"):
            so = out / f"parent_{name}.so"
            r = subprocess.run([nvcc, *kb.NVCC_FLAGS, "-o", str(so), str(parent / f"{name}.cu")],
                               capture_output=True, text=True)
            log(f"parent {name} build rc {r.returncode} {r.stdout[-2000:]}{r.stderr[-2000:]}")
            import ctypes
            libs[name] = ctypes.CDLL(str(so))
        own_load = kb.load

        def with_parent(fn):
            def call():
                kb.load = lambda name: libs[name]
                try:
                    return fn()
                finally:
                    kb.load = own_load
            return call
        # K3/K4: the parent's bits.
        import petastorm_tpu_torch.ops.flash_attn as fam
        for (b, s, h, kv_h, d, dtype) in [(2, 1000, 8, 2, 128, torch.bfloat16), (1, 300, 4, 2, 64, torch.float16),
                                          (1, 77, 4, 1, 72, torch.bfloat16), (2, 8192, 32, 8, 128, torch.bfloat16)]:
            g = torch.Generator(device="cuda").manual_seed(s + d)
            rn = lambda *sh: torch.randn(sh, generator=g, device="cuda").to(dtype)
            q, k, v, do = rn(b, s, h, d), rn(b, s, kv_h, d), rn(b, s, kv_h, d), rn(b, s, h, d)
            o, lse = fa.flash_attention_plain(q, k, v, causal=True)
            mine = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
            theirs = with_parent(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True))()
            torch.cuda.synchronize()
            log(f"[bwd bits] {(b, s, h, kv_h, d, dtype)}: equal to the parent's "
                f"{[torch.equal(x, y) for x, y in zip(mine, theirs)]}")
        # K1: this tree's and the parent's, by three timings.
        x = torch.randint(0, 256, (256, 224, 224, 3), device="cuda", dtype=torch.uint8)
        fns = {"K1": lambda: normalize_images(x), "K1 parent": with_parent(lambda: normalize_images(x)),
               "plain": lambda: normalize_images_plain(x)}
        log("[k1 time] events around one call (as chip_smoke.py timed it before the device sleep):", median_ms(fns, 50))
        log("[k1 time] behind a device sleep, one call:", sleep_ms(fns, 50))
        log("[k1 time] behind a device sleep, 20 calls back to back:", sleep_ms(fns, 10, 20))
        b, s, h, kv_h, d = 2, 8192, 32, 8, 128
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(b, s, n, d, generator=g, device="cuda").bfloat16() for n in (h, kv_h, kv_h))
        flops = 4 * b * h * d * s * (s + 1) // 2
        ms = sleep_ms({"tc out": lambda: fa._flash_fwd(fa.TENSOR_CORES, q, k, v, True, False),
                       "tc lse": lambda: fa._flash_fwd(fa.TENSOR_CORES, q, k, v, True, True),
                       "sdpa": lambda: F.scaled_dot_product_attention(
                           q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                           enable_gqa=True)}, 10)
        log("[time] token shape behind a device sleep:",
            {n: f"{t:.4f} ms, {flops / t / 1e9:.1f} TFLOP/s" for n, t in ms.items()})
    except Exception:
        log("parent FAILED", traceback.format_exc()[-3000:])

# Variants of csrc/flash_attn.cu under build/variants/ (experiments made by
# hand): ptxas warnings and registers, then K2's time at the token shape.
variants = sorted((ROOT / "build" / "variants").glob("*.cu"))
if variants:
    import ctypes
    vlibs = {}
    procs = {}
    for src in variants:
        procs[src.stem] = (
            subprocess.Popen([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                              "-I", str(kb.CSRC_DIR), "-cubin", "-Xptxas", "-v", "-o",
                              str(out / f"v_{src.stem}.cubin"), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            subprocess.Popen([nvcc, *kb.NVCC_FLAGS, "-I", str(kb.CSRC_DIR), "-o",
                              str(out / f"v_{src.stem}.so"), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for name, (pv, pb) in procs.items():
        text = pv.communicate()[0].decode(errors="replace")
        btext = pb.communicate()[0].decode(errors="replace")
        lines = text.splitlines()
        regs = [lines[i + 2].strip() for i, l in enumerate(lines)
                if "flash_fwd_tc_kernel" in l and "Compiling" in l and i + 2 < len(lines)]
        log(f"[variant {name}] rc {pv.returncode}/{pb.returncode}: serialised-wgmma warnings "
            f"{text.count('C7513')}; tc kernels: {regs}; {btext[-1500:] if pb.returncode else ''}")
        if pb.returncode == 0:
            vlibs[name] = ctypes.CDLL(str(out / f"v_{name}.so"))
    b, s, h, kv_h, d = 2, 8192, 32, 8, 128
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, s, n, d, generator=g, device="cuda").bfloat16() for n in (h, kv_h, kv_h))
    flops = 4 * b * h * d * s * (s + 1) // 2
    want = fa.flash_attention_plain(q, k, v, causal=True)[0].float()
    own_load = kb.load

    def using(lib):
        def call():
            kb.load = lambda name: lib if name == "flash_attn" else own_load(name)
            try:
                return fa._flash_fwd(fa.TENSOR_CORES, q, k, v, True, False)[0]
            finally:
                kb.load = own_load
        return call
    fns = {"tree": lambda: fa._flash_fwd(fa.TENSOR_CORES, q, k, v, True, False)[0]}
    fns.update((name, using(lib)) for name, lib in vlibs.items())
    small = []
    for (sb, sq_, sk_, sh, skv, sd, sc, sdt) in [(1, 100, 100, 4, 2, 64, True, torch.bfloat16),
                                                  (2, 77, 130, 4, 1, 64, False, torch.float16),
                                                  (2, 96, 64, 4, 2, 128, True, torch.bfloat16),
                                                  (1, 963, 963, 8, 2, 128, True, torch.bfloat16),
                                                  (1, 300, 300, 4, 2, 72, True, torch.bfloat16)]:
        xs = [torch.randn(sb, n_, hh, sd, generator=g, device="cuda").to(sdt)
              for n_, hh in ((sq_, sh), (sk_, skv), (sk_, skv))]
        small.append((xs, sc, fa.flash_attention_plain(*xs, causal=sc)))
    for name, lib in [("tree", None)] + list(vlibs.items()):
        try:
            if lib is not None:
                kb.load = lambda n, lib=lib: lib if n == "flash_attn" else own_load(n)
            errs = [(fa._flash_fwd(fa.TENSOR_CORES, *xs, sc, True)[0].float() - w[0].float()).abs().max().item()
                    for xs, sc, w in small]
            lse_errs = [(fa._flash_fwd(fa.TENSOR_CORES, *xs, sc, True)[1] - w[1]).abs().max().item()
                        for xs, sc, w in small]
            kb.load = own_load
            err = (fns[name]().float() - want).abs().max().item()
            torch.cuda.synchronize()
            log(f"[variant {name}] token shape max abs err {err:.3g}; small cases o {errs}, lse {lse_errs}")
        except Exception:
            kb.load = own_load
            log(f"[variant {name}] FAILED", traceback.format_exc()[-1500:])
    ms = sleep_ms(fns, 10)
    log("[variant time] token shape, 'out' mode, behind a device sleep:",
        {n: f"{t:.4f} ms, {flops / t / 1e9:.1f} TFLOP/s" for n, t in ms.items()})
log("probe done")
