"""Saliency traffic: the mnist-saliency harness with the stack expanded on
the card (`-saliencyDumpStack 0`): `mgtpu_torch.pipelines.saliency.GroupStep`
on groups of ``group`` base images, group g + 1 dispatched before group
g's results (probe validity, probe boxes, saliency maps and the base
images) are read to the host, as `saliency_samples` runs them.

The net is the mnist-saliency harness's: the trained net its checkpoint
names, here the benchmark's weights for the configuration. The loader
is the dataset's definition: the occlusion masks and noise of
`reference.saliency`, the MNIST normalisation. Base images are sparse
clutter in [0, 1], normalised, made on the card from the seed. After the
window a sample of the groups, drawn from the seed, is compared with the
reference's stacks, forward and probe: the probes' validity and boxes
(``probe_mismatch``) and the saliency maps (``sal_err``).

Traffic keys: group, base_images, clutter, mask_window, mask_stride,
compare_groups."""

from __future__ import annotations

import random
import time
from types import SimpleNamespace

import torch

from portbench.common import inputs
from portbench.common.harness import exact_f32
from portbench.reference import mgnet, saliency


def reference(net, params, stats, base, mask, noise, quant=None, tf32=False):
    """(valid, points, saliency) of the reference for base images (k, H, W, 1);
    with ``tf32`` its convs in TF32."""
    with torch.no_grad(), exact_f32(tf32):
        st = saliency.stacks(base, mask, noise)
        outs = torch.stack([mgnet.forward(net, params, stats, s, "eval", quant) for s in st])
        valid, points = saliency.interest_points(outs[:, 0])
        return valid, points, saliency.saliency_maps(outs, points, mask)


def numbers(got, ref):
    """probe_mismatch: the share of (sample, probe) whose validity or box
    differs; sal_err: sum |map - reference| over sum |reference| on the
    probes that agree (infinite where none does)."""
    bad = total = 0
    diff = norm = 0.0
    for (gv, gp, gs), (rv, rp, rs) in zip(got, ref):
        for j in range(len(rv)):
            total += gp.shape[1]
            if bool(gv[j]) != bool(rv[j]):
                bad += gp.shape[1]
                continue
            if not rv[j]:
                continue
            for p in range(gp.shape[1]):
                if not torch.equal(gp[j, p], rp[j, p]):
                    bad += 1
                    continue
                diff += float((gs[j, p].double() - rs[j, p].double()).abs().sum())
                norm += float(rs[j, p].double().abs().sum())
    return {"probe_mismatch": bad / max(total, 1),
            "sal_err": diff / norm if norm > 0 else float("inf")}


def shift_probe(points, probe=0):
    """The boxes with probe ``probe``'s moved one column: a fault in the
    interest points."""
    points = points.clone()
    points[:, probe] = points[:, probe].roll(1, -2)
    return points


def run(h):
    from mgtpu_torch.models import create_model
    from mgtpu_torch.models.base import NetOpts
    from mgtpu_torch.pipelines.saliency import GroupStep

    h.mark("imported")
    cfg, tr = h.config, h.traffic
    net = mgnet.build(cfg)
    k, n_base = tr["group"], tr["base_images"]
    g = h.generator(1)
    img = torch.rand((n_base, *cfg["image_shape"]), generator=g, device=h.device)
    img = img * (torch.rand(img.shape, generator=g, device=h.device) < tr["clutter"])
    mean, std = saliency.MEANSTD[0][0], saliency.MEANSTD[1][0]
    base = (img - mean) / std
    params, stats = inputs.weights(h, net, images=base[:inputs.bn_batch(cfg["image_shape"])])
    base_np = base.cpu().numpy()
    mask_np = saliency.occlusion_masks(cfg["image_shape"][0], tr["mask_window"],
                                       tr["mask_stride"])
    noise_np = saliency.occlusion_noise(mask_np)
    h.mark("inputs")
    loader = SimpleNamespace(mask=mask_np, expand="device", noise=noise_np,
                             meanstd=saliency.MEANSTD)
    with inputs.checkpoint(h, params, stats, cfg["opts"]) as path:
        model = create_model(NetOpts(netType=tr["harness"], trainedNet=path),
                             device=h.device).eval()
    step = GroupStep(model, loader, k, dump_stack=False, device=h.device)
    h.mark("built")

    results = {}

    def dispatch(gi):
        lo = (gi * k) % n_base
        with h.span("dispatch"):
            return gi, step(base_np[lo:lo + k])

    def consume(gi, out):
        with h.span("readback"):
            results[gi] = tuple(t.cpu() for t in out)

    pending = dispatch(0)  # warm-up: two groups through the window's pattern
    nxt = dispatch(1)
    consume(*pending)
    consume(*nxt)
    h.setup_done()
    results.clear()

    start, over = h.window()
    gi, pending = 0, dispatch(0)
    while not over():
        gi += 1
        nxt = dispatch(gi)
        consume(*pending)
        pending = nxt
    consume(*pending)
    wall = time.perf_counter() - start
    rate = len(results) * k / wall
    failed = sum(int((~torch.isfinite(r[2])).any()) for r in results.values())

    def body(warm):
        n = 1 if warm else 2
        p = dispatch(0)
        for j in range(1, n + 1):
            q = dispatch(j) if j < n else None
            consume(*p)
            p = q
        return n

    dispatch_s = list(h.spans["dispatch"])
    window = dict(results)
    h.profiled(body)
    peak = torch.cuda.max_memory_allocated(h.device) if h.device.type == "cuda" else 0
    h.info(window_groups=len(window), window_s=wall, samples=len(window) * k)
    del step, model
    h.free()

    picks = random.Random(h.seed).sample(sorted(window), min(tr["compare_groups"], len(window)))
    mask = torch.from_numpy(mask_np).to(h.device)
    noise = torch.from_numpy(noise_np).to(h.device)

    def ref_of(gi, quant=None, tf32=False):
        lo = (gi * k) % n_base
        return tuple(t.cpu() for t in reference(net, params, stats, base[lo:lo + k], mask,
                                                noise, quant, tf32))

    ref = [ref_of(gi) for gi in picks]
    got = [window[gi][:3] for gi in picks]
    found = numbers(got, ref)
    h.info(probes=sum(v.numel() for v, _, _ in ref) * 7,
           valid_samples=sum(int(v.sum()) for v, _, _ in ref))
    h.compare("probe_mismatch", found["probe_mismatch"])
    h.compare("sal_err", found["sal_err"])
    if h.readings:  # the control (bf16 operands), the reference in TF32 (which the
        # configuration allows), and answers altered where they are made
        ctrl = [ref_of(gi, mgnet.Quant("bf16")) for gi in picks]
        tf32 = [ref_of(gi, tf32=True) for gi in picks]
        rolled = [(v, p, s.roll(1, 0)) for v, p, s in got]
        h.extra = {"control": numbers(ctrl, ref), "tf32": numbers(tf32, ref),
                   "answer_altered": numbers(rolled, ref),
                   "probe_moved": numbers([(v, shift_probe(p), s) for v, p, s in got], ref)}
    return {"attempted": len(window) * k, "failed": failed * k, "peak": peak,
            "dispatch": dispatch_s,
            "metrics": {"saliency_samples_s": (rate, "samples/s")}, "rate": rate,
            "work": {"kind": "saliency", "group": k, "stack": 1 + mask_np.shape[0]}}
