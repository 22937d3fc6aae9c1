"""How far a served LM's logits move under rounding-sized changes, on the
card.

    PYTHONPATH=src python -m repro_torch.launch.lm_rounding \\
        --arch olmoe-1b-7b --arch nemotron-4-15b --rescale-experts

For each arch at full width and depth (bf16, weights from seed 0), one
prefill of 2 x 2048 random tokens three ways: attention on the flash
kernel (the served route), on the plain chunked math, and on the plain
math with P V in f32 (P not rounded to bf16: a rounding-sized change of
every attention). MoE choices are pinned to the kernel route's
(``apply_moe(gate_idx=)``), so the three differ only in rounding; each
prints max |a - b| / max |b| of the logits and of every layer's output
(the plain route's own distance is the model's rounding floor), and, by
layer, the share of tokens whose top-k under the plain route differs
from the kernel route's (the earlier layers pinned: each layer's own
flips, before any compound). With ``--rescale-experts``
an MoE arch runs again with its experts scaled to fan-in d_model and
d_ff (the reference draws them at fan-in E). One JSON line an arch.
"""
import argparse
import contextlib
import json

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.models import LM
from repro_torch.models import attention as attn
from repro_torch.models import moe

PROMPT, BATCH = 2048, 2


def _grid_block(shift: float):
    """``attention._block_attend`` with P rounded to v's dtype on a grid
    scaled by ``shift`` (P shift rounded, the product over shift, in f32):
    the plain route's own rounding of P, drawn again."""
    def block(q, k, v, mask):
        s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())
        while mask.dim() < s.dim():
            mask = mask[None]
        p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
        p = p.masked_fill(~mask.any(dim=-1, keepdim=True), 0.0)
        p = (p * shift).to(v.dtype).float()
        return (torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
                / shift).to(v.dtype)
    return block


@contextlib.contextmanager
def attention_route(name: str):
    """``attend`` on the card through ``kernel`` (the flash kernel),
    ``plain`` (the chunked math), ``plain_f32_pv`` (P V in f32) or
    ``plain_grid:<shift>`` (P rounded on a grid scaled by the shift:
    rounding-sized changes of the plain route that share nothing with the
    kernels' arithmetic)."""
    kernel, block = attn._attend_kernel, attn._block_attend

    def f32_pv(q, k, v, **kw):
        return attn._attend_local(q, k.float(), v.float(), **kw).to(q.dtype)
    if name.startswith("plain_grid:"):
        attn._block_attend = _grid_block(float(name.split(":")[1]))
        name = "plain"
    attn._attend_kernel = {"kernel": kernel, "plain": attn._attend_local,
                           "plain_f32_pv": f32_pv}[name]
    try:
        yield
    finally:
        attn._attend_kernel, attn._block_attend = kernel, block


@contextlib.contextmanager
def pinned_routes(own: list, pin=None):
    """Each ``apply_moe`` call appends its router's top-k to ``own`` and
    takes the next of ``pin`` (in call order) when one is given."""
    apply = moe.apply_moe
    it = None if pin is None else iter(pin)

    def pinned(cfg, params, x, gate_idx=None):
        mine = moe.route(cfg, params, x)[1]
        own.append(mine)
        return apply(cfg, params, x, gate_idx=mine if it is None
                     else next(it))
    moe.apply_moe = pinned
    try:
        yield
    finally:
        moe.apply_moe = apply


def choice_flips(own: list, pinned: list) -> list:
    """For each MoE call, the share of tokens whose own top-k differs from
    the pinned one (as sets)."""
    return [float((a.sort(-1)[0] != b.sort(-1)[0]).any(-1).float().mean())
            for a, b in zip(own, pinned)]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs_().max()) / float(
        b.float().abs().max())


def measure(arch: str, rescale: bool) -> dict:
    cfg = get_config(arch, smoke=False)
    lm = LM(cfg, device="cuda", seed=0)
    if rescale:
        e = cfg.moe.num_experts
        for blk in lm.layers:
            if blk.moe:
                for name in ("wi", "wg"):
                    if name in blk.ffn:
                        blk.ffn[name].mul_((e / cfg.d_model) ** 0.5)
                blk.ffn["wo"].mul_((e / cfg.d_ff) ** 0.5)
    gen = torch.Generator(device=lm.device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=gen, device=lm.device,
                           dtype=torch.int32)
    outs, layers, routes = {}, {}, {}
    with torch.no_grad():
        for name in ("kernel", "plain", "plain_f32_pv"):
            hooks = [blk.register_forward_hook(
                lambda m, i, o, n=name: layers.setdefault(n, []).append(
                    o[0])) for blk in lm.layers]
            own = routes.setdefault(name, [])
            with attention_route(name), pinned_routes(
                    own, None if name == "kernel" else routes["kernel"]):
                outs[name] = lm.prefill({"tokens": tokens},
                                        PROMPT + 1)[0]
            for h in hooks:
                h.remove()
    out = {"arch": arch, "rescaled_experts": rescale,
           "device": torch.cuda.get_device_name(lm.device)}
    for a, b in (("kernel", "plain"), ("plain_f32_pv", "plain")):
        key = f"{a}_vs_{b}"
        out[key] = rel(outs[a], outs[b])
        out[key + "_by_layer"] = [rel(x, y) for x, y in
                                  zip(layers[a], layers[b])]
    if routes["kernel"]:
        out["plain_unpinned_choice_flips_by_layer"] = choice_flips(
            routes["plain"], routes["kernel"])
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", required=True)
    ap.add_argument("--rescale-experts", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lm_rounding measures on the card; "
                         "torch.cuda.is_available() is False")
    ref.full_f32(torch.device("cuda"))
    recs = []
    for arch in args.arch:
        runs = [False]
        if args.rescale_experts and get_config(arch).moe is not None:
            runs.append(True)
        for rescale in runs:
            rec = measure(arch, rescale)
            print(json.dumps(rec), flush=True)
            recs.append(rec)
            torch.cuda.empty_cache()
    return recs


if __name__ == "__main__":
    main()
