#!/usr/bin/env python3
"""A short first check of the training attention kernels (csrc/attention.cu)
on one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/probe_attention.py

from the root of a checkout, on a machine with a CUDA card and nvcc. It
compiles scripts/probe_wgmma.cu (one warpgroup's products through
csrc/hopper.cuh: both operands K-major, A from registers with B MN-major,
both MN-major) and holds them against torch.matmul at head dims 32 and 64;
builds the port's kernels and prints ptxas's lines and the HGMMA count of
each attention kernel; holds the forward (o, lse) and the backward (dq, dk,
dv, fed the plain forward's o and lse) against their plain versions at the
pvlt_tiny stage shapes at B = 4, the ragged shape, M = 177 and M = 272, and
at B = 150, printing every error without stopping; checks that two B = 150
stage-1 backward calls are bit-equal; and times both kernels at the B = 150
stage shapes beside F.scaled_dot_product_attention. chip_smoke.py makes the
full checks and measurements. The work runs in a child process that is
killed after 480 s.
"""

import ctypes
import json
import subprocess
import sys
import time

import torch

import chip_smoke as c
from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.pallas_attention import (attention_bwd, attention_fwd,
                                                 attention_stats_bwd_reference,
                                                 attention_stats_reference)

SHAPES = [(f"stage{i + 1}", (h, w, d, nh, sr, hid, c.TEXT))
          for i, (h, w, d, nh, sr, hid) in enumerate(c.STAGES)]


def probe_layouts() -> None:
    out = c.REPO / "build" / "probe_wgmma.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                           str(_build.CSRC), "-o", str(out), "scripts/probe_wgmma.cu"],
                          capture_output=True, text=True, check=False)
    print(json.dumps({"probe_build": proc.returncode, "log": proc.stdout[-1500:] +
                      proc.stderr[-3000:]}), flush=True)
    if proc.returncode:
        return
    lib = ctypes.CDLL(str(out))
    lib.probe_wgmma.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int]
    gen = torch.Generator().manual_seed(0)
    for hd in (32, 64):
        q, k, v = (torch.randn(64, hd, generator=gen).to("cuda", torch.bfloat16)
                   for _ in range(3))
        e = torch.randn(64, 64, generator=gen).to("cuda", torch.bfloat16)
        s = torch.zeros(64, 64, device="cuda")
        o, x = torch.zeros(64, hd, device="cuda"), torch.zeros(64, hd, device="cuda")
        err = lib.probe_wgmma(q.data_ptr(), k.data_ptr(), v.data_ptr(), e.data_ptr(),
                              s.data_ptr(), o.data_ptr(), x.data_ptr(), hd)
        torch.cuda.synchronize()
        want_s = q.float() @ k.float().T
        want_o = want_s.to(torch.bfloat16).float() @ v.float()
        want_x = e.float().T @ k.float()
        print(json.dumps({"probe": hd, "err": err,
                          "S": c._rel_err(s, want_s)[1], "O": c._rel_err(o, want_o)[1],
                          "X": c._rel_err(x, want_x)[1]}), flush=True)


def build_report() -> None:
    _, log, secs = _build.build()
    lines = log.splitlines()
    keep = []
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and "attn_" in ln:
            keep += lines[i:i + 4]
    print(json.dumps({"build_s": secs, "ptxas": [ln.strip() for ln in keep
                                                  if "Compiling" in ln or "registers" in ln
                                                  or "spill" in ln or "warn" in ln.lower()]}),
          flush=True)
    print(json.dumps({"hgmma": c.hgmma_counts(_build.library_path())}), flush=True)
    _build.load_library()


def check(label, shape, batch, gen) -> None:
    a = c.train_kernel_inputs(gen, shape, batch)
    q, k, v, do, sc = a["q"], a["k"], a["v"], a["do"], a["scale"]
    row = {"shape": label, "batch": batch, "m": k.shape[2], "hd": q.shape[3]}
    try:
        o_ref, lse_ref = attention_stats_reference(q, k, v, sc)
        o, lse = attention_fwd(q, k, v, sc)
        grads = attention_bwd(q, k, v, o_ref, lse_ref, do, sc)
        want = attention_stats_bwd_reference(q, k, v, o_ref, lse_ref, do, sc)
        torch.cuda.synchronize()
        row.update({"o": c._rel_err(o, o_ref)[1], "lse": c._rel_err(lse, lse_ref)[1],
                    **{n: c._rel_err(g, w)[1] for n, g, w in zip(("dq", "dk", "dv"), grads,
                                                                 want)}})
    except Exception as exc:  # noqa: BLE001 -- a probe prints every failure and goes on
        row["error"] = repr(exc)[:500]
    print(json.dumps(row), flush=True)


def device_ms(fn, calls: int = 10) -> dict:
    """Device time per call by kernel name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0:
            out[evt.key[:60]] = evt.self_device_time_total / 1e3 / calls
    return out


def main() -> None:
    t0 = time.time()
    c.phase_device()
    probe_layouts()
    build_report()
    gen = torch.Generator().manual_seed(c.SEED + 7)
    extra = [("ragged", c.TRAIN_RAGGED), ("m177", c.TRAIN_M177), ("m272", c.TRAIN_M272)]
    for label, shape in SHAPES + extra:
        check(label, shape, c.SMOKE_BATCH, gen)
    for label, shape in SHAPES:
        check(label, shape, c.TRAIN_BATCH, gen)
        torch.cuda.empty_cache()
    a = c.train_kernel_inputs(gen, SHAPES[0][1], c.TRAIN_BATCH)
    o, lse = attention_fwd(a["q"], a["k"], a["v"], a["scale"])
    one = attention_bwd(a["q"], a["k"], a["v"], o, lse, a["do"], a["scale"])
    two = attention_bwd(a["q"], a["k"], a["v"], o, lse, a["do"], a["scale"])
    print(json.dumps({"bit_equal": all(torch.equal(x, y) for x, y in zip(one, two))}),
          flush=True)
    del a, o, lse, one, two
    for label, shape in SHAPES:
        a = c.train_kernel_inputs(gen, shape, c.TRAIN_BATCH)
        q, k, v, do, sc = a["q"], a["k"], a["v"], a["do"], a["scale"]
        o, lse = attention_fwd(q, k, v, sc)
        sdpa_fwd, sdpa_bwd, _ = c.sdpa_times(a)
        fwd = lambda: attention_fwd(q, k, v, sc)
        bwd = lambda: attention_bwd(q, k, v, o, lse, do, sc)
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        so = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, scale=sc)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(50):
            fwd()
        host_fwd_us = (time.perf_counter() - start) / 50 * 1e6
        torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=sc)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(20):
            torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=sc)
        host_sdpa_us = (time.perf_counter() - start) / 20 * 1e6
        torch.cuda.synchronize()
        print(json.dumps({"time": label, "host_fwd_us": host_fwd_us,
                          "host_sdpa_fwd_us": host_sdpa_us, "fwd_ms": c.cuda_time_ms(fwd),
                          "bwd_ms": c.cuda_time_ms(bwd), "sdpa_fwd_ms": sdpa_fwd,
                          "sdpa_bwd_ms": sdpa_bwd,
                          "bounds": c.train_bounds(shape, c.TRAIN_BATCH),
                          "device_fwd": device_ms(fwd), "device_bwd": device_ms(bwd),
                          "device_sdpa_fwd": device_ms(lambda: torch.nn.functional.
                                                       scaled_dot_product_attention(
                                                           q, k, v, scale=sc)),
                          "device_sdpa_bwd": device_ms(lambda: torch.autograd.grad(
                              so, (ql, kl, vl), do, retain_graph=True))}), flush=True)
        del so, ql, kl, vl
        del a, o, lse
        torch.cuda.empty_cache()
    host_breakdown()
    print(json.dumps({"seconds": time.time() - t0}), flush=True)


def host_breakdown() -> None:
    """Host microseconds per call of the forward wrapper's pieces."""
    from mvlt_tpu_torch.ops import pallas_attention as pa
    gen = torch.Generator().manual_seed(0)
    a = c.train_kernel_inputs(gen, SHAPES[3][1], c.TRAIN_BATCH)
    q, k, v = a["q"], a["k"], a["v"]
    lib = _build.load_library()
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    st = _build.strides_arg(q, k, v, o)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    pieces = {
        "check_x3": lambda: [pa._check("f", t, "t") for t in (q, k, v)],
        "empty_like": lambda: torch.empty_like(q),
        "empty_lse": lambda: torch.empty(q.shape[:3], dtype=torch.float32, device=q.device),
        "strides_arg": lambda: _build.strides_arg(q, k, v, o),
        "current_stream": lambda: torch.cuda.current_stream(q.device).cuda_stream,
        "load_library": _build.load_library,
        "ctypes_launch": lambda: lib.mvlt_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), st,
            *q.shape[:3], k.shape[2], q.shape[3], a["scale"], stream),
        "wrapper": lambda: pa.attention_fwd(q, k, v, a["scale"]),
    }
    out = {}
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(30):
            fn()
        out[name] = (time.perf_counter() - start) / 30 * 1e6
        torch.cuda.synchronize()
    print(json.dumps({"host_us": out}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        main()
    else:   # a watchdog: a kernel that never returns is killed with its process
        sys.exit(subprocess.run([sys.executable, __file__, "--child"], timeout=480,
                                check=False).returncode)
