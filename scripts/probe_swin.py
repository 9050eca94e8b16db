#!/usr/bin/env python3
"""A short first check of the Swin kernels on one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/probe_swin.py

from the root of a checkout, on a machine with a CUDA card and nvcc. It
builds the port's kernels, prints ptxas's lines for the Swin kernels, holds
kernel E (ops/swin_band.py) and kernel F (ops/swin_attention.py) against
their plain versions at the pvlt_swin_tiny stage shapes and a few others
(max |kernel - plain| / max |plain|), then runs pvlt_swin_tiny with
create_model's own initialisation at 256 and at 224: the ITM logits of two
pairs on the card beside the fp32 CPU model, and the ms of a forward at
B = 101 on float images (host clock around 5 forwards after 3 warm-up).
chip_smoke.py makes the full checks and measurements; this is its quick,
short-lived precursor for a new kernel's first call on the card.
"""

import json
import time

import torch

from mvlt_tpu_torch.config import LossType, ModelConfig
from mvlt_tpu_torch.models.pvlt import create_model
from mvlt_tpu_torch.models.swin import add_table, relative_position_index, window_masks
from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.swin_attention import fused_swin_attention, swin_attention_reference
from mvlt_tpu_torch.ops.swin_band import fused_swin_block, swin_block_reference


def main() -> None:
    t0 = time.time()
    _, log, secs = _build.build()
    print("build", secs, flush=True)
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and "swin" in ln:
            print("\n".join(lines[i:i + 3]))
    _build.load_library()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def rnd(*s, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*s, generator=gen)).to(dev)

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    def block_params(d, heads, hidden, ws):
        mat = lambda o, i, g: rnd(o, i, std=g / i ** 0.5)
        return [rnd((2 * ws - 1) ** 2, heads, std=0.5), rnd(d, std=0.1, mean=1),
                rnd(d, std=0.1), mat(d, d, 1.5), rnd(d, std=0.05), mat(2 * d, d, 1.5),
                rnd(2 * d, std=0.05), mat(d, d, 1.0), rnd(d, std=0.05),
                rnd(d, std=0.1, mean=1), rnd(d, std=0.1), mat(hidden, d, 1.0),
                rnd(hidden, std=0.05), mat(d, hidden, 1.0), rnd(d, std=0.05)]

    for (h, w, d, nh, hid, b) in [(64, 64, 64, 1, 512, 4), (32, 32, 128, 2, 1024, 4),
                                  (16, 16, 320, 5, 1280, 4), (8, 8, 512, 8, 2048, 4),
                                  (56, 56, 64, 1, 512, 4), (16, 16, 320, 5, 1280, 101),
                                  (8, 8, 512, 8, 2048, 101), (12, 12, 96, 3, 384, 3)]:
        ws = 8 if h % 8 == 0 else 6
        for shift in (0, ws // 2):
            p = block_params(d, nh, hid, ws)
            x = rnd(b, h * w, d).to(torch.bfloat16)
            kt, vt = rnd(b, 128, d).to(torch.bfloat16), rnd(b, 128, d).to(torch.bfloat16)
            kw = dict(hw=(h, w), heads=nh, window=ws, shift=shift, pool=max(1, h // 8),
                      eps1=1e-6, eps2=1e-6)
            table = add_table(p[0], torch.from_numpy(relative_position_index(ws)).to(dev),
                              torch.from_numpy(window_masks(h, w, ws, shift)).to(dev), 128)
            out, pooled = fused_swin_block(x, kt, vt, *p, **kw, table=table)
            ro, rp = swin_block_reference(x, kt, vt, *p, **kw)
            torch.cuda.synchronize()
            print(json.dumps({"E": [h, w, d, nh, b, shift], "out": rel(out, ro),
                              "pooled": rel(pooled, rp)}), flush=True)

    for (nw, nh, ws2, b) in [(16, 2, 64, 4), (4, 5, 64, 4), (1, 8, 49, 4), (16, 2, 64, 101),
                             (3, 3, 36, 2)]:
        hd = 64 if nh != 3 else 32
        q, k, v = (rnd(b, nw, nh, ws2, hd).to(torch.bfloat16) for _ in range(3))
        kt, vt = (rnd(b, nh, 128, hd).to(torch.bfloat16) for _ in range(2))
        table = rnd(nw, nh, ws2, ws2 + 128, std=0.5)
        table[..., :ws2] += torch.where(torch.rand(nw, nh, ws2, ws2, generator=gen) < 0.3,
                                        -1e9, 0.0).to(dev)
        got = fused_swin_attention(q, k, v, kt, vt, table, scale=hd ** -0.5)
        want = swin_attention_reference(q, k, v, kt, vt, table, scale=hd ** -0.5)
        torch.cuda.synchronize()
        print(json.dumps({"F": [nw, nh, ws2, b], "err": rel(got, want)}), flush=True)

    itm = LossType(itm=True, mlm=False, t2i=False, cls=False)
    for size in (256, 224):
        torch.manual_seed(0)
        m = create_model(ModelConfig(name="pvlt_swin_tiny", compute_dtype="bfloat16",
                                     loss_type=itm), device="cuda", input_size=size).eval()
        cpu = create_model(ModelConfig(name="pvlt_swin_tiny", compute_dtype="float32",
                                       loss_type=itm), device="cpu", input_size=size).eval()
        cpu.load_state_dict({k: v.detach().cpu() for k, v in m.state_dict().items()})
        im = torch.rand(2, size, size, 3, generator=gen)
        ids = torch.randint(0, 30000, (2, 128), generator=gen)
        with torch.no_grad():
            g = m(im.cuda(), ids.cuda())["itm_logits"].float().cpu()
            want = cpu(im, ids)["itm_logits"]
        print(json.dumps({"model": size, "card": g.flatten().tolist(),
                          "cpu": want.flatten().tolist(),
                          "rel": ((g - want).abs().max() / want.abs().max()).item()}), flush=True)
        imb = torch.rand(101, size, size, 3).cuda()
        idb = torch.randint(0, 30000, (101, 128)).cuda()
        with torch.no_grad():
            for _ in range(3):
                m(imb, idb)
            torch.cuda.synchronize()
            t = time.time()
            for _ in range(5):
                m(imb, idb)
            torch.cuda.synchronize()
        print(json.dumps({"model_ms": size, "ms": (time.time() - t) / 5 * 1e3}), flush=True)
    print("total", time.time() - t0)


if __name__ == "__main__":
    main()
