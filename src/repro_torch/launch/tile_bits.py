"""Every tile kernel's outputs at fixed inputs, for a bit-for-bit check
across two trees of the port: a redesign of a tile kernel that must keep
every output bit saves them from each tree and compares the files.

    PYTHONPATH=A/src python A/src/repro_torch/launch/tile_bits.py save a.pt
    PYTHONPATH=B/src python A/src/repro_torch/launch/tile_bits.py save b.pt
    python A/src/repro_torch/launch/tile_bits.py compare a.pt b.pt

``save`` runs, on the card, ``distance_argmin``, ``lloyd_step``,
``distance_argmin_ft`` (clean and with a planted distance fault),
``lloyd_step_ft``, ``lloyd_step_pruned`` (a random and an all-zero skip
mask) and, at 2 bytes, ``lloyd_step_batched_entries``, at f32, bf16 and
fp16, row tiles of 64 and 128, on blob data at (M, F, K) = (20000, 100,
1000), (5000, 300, 1000) (X streamed at 2 bytes and BM 128), (9000, 20,
200) and (7000, 100, 100), from whichever ``repro_torch`` the path gives;
a one-pass step's update is saved as the tree over it (entries or dense
partials, so trees before and after a change of layout compare).
``compare`` prints each output whose bits differ and exits 1 if any does.
"""
from __future__ import annotations

import sys

CASES = ((20000, 100, 1000), (5000, 300, 1000), (9000, 20, 200),
         (7000, 100, 100))


def _sums(up, upd, nt: int) -> tuple:
    """(sums, counts) of a one-pass step's update over nt row tiles (a
    problem's): its entries (entries, ecnt, idx) or its dense partials
    (sums, counts) through the tree."""
    if len(upd) == 3:
        return tuple(up.reduce_entries(*upd, ntiles=nt))
    return up.tree_sum(upd[0]), up.tree_sum(upd[1])


def save(path: str) -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.data.blobs import make_blobs
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.kernels import distance_argmin_ft as daft
    from repro_torch.kernels import lloyd_step as ll
    from repro_torch.kernels import lloyd_step_ft as llft
    from repro_torch.kernels import lloyd_step_pruned as llp
    from repro_torch.kernels import ops, update as up
    out = {}

    def put(key, *ts):
        for i, t in enumerate(ts):
            out[f"{key}/{i}"] = t.detach().cpu().clone()

    for dt in (torch.bfloat16, torch.float16, torch.float32):
        for m, f, k in CASES:
            x = torch.from_numpy(make_blobs(m, f, k, seed=m + f)[0]).cuda()
            gen = torch.Generator().manual_seed(k)
            c = x[torch.randperm(m, generator=gen)[:k].cuda()].clone()
            for bm in (128, 64):
                params = ops.clamp_params(m, k, f, ops.KernelParams(bm, 128,
                                                                    32))
                plan, cp, cn, _ = ops._resolve_padded(
                    ops.plan_data(x.to(dt), params), c, None)
                tiles = dict(block_m=bm, block_k=params.block_k,
                             block_f=params.block_f)
                xp, key = plan.xp, f"{dt}/{m}_{f}_{k}_bm{bm}"
                mp, kp = xp.shape[0], cp.shape[0]
                nt = mp // bm
                put(f"{key}/da", *da.distance_argmin(xp, cp, cn, **tiles))
                r = ll.lloyd_step(xp, cp, cn, plan.m, **tiles)
                put(f"{key}/ll", r[0], r[1], *_sums(up, r[2:5], nt))
                factor = ops.threshold_factor(xp.shape[1], dt)
                fault = ops.plan_injection_tile(m, k, f, params, row=m // 3,
                                                col=k - 3, f_step=1,
                                                delta=2.0 ** 20).cuda()
                for name, inj in (("clean", daft.no_injection().cuda()),
                                  ("fault", fault)):
                    put(f"{key}/daft_{name}", *daft.distance_argmin_ft(
                        xp, cp, cn, inj, factor=factor, **tiles))
                q = llft.lloyd_step_ft(xp, cp, cn,
                                       llft.no_injection().cuda(), plan.m,
                                       factor=factor, **tiles)
                put(f"{key}/llft", q[0], q[1], q[2], q[8], q[9],
                    *_sums(up, q[3:6], nt))
                xn = F.pad(plan.xn, (0, mp - plan.m)).contiguous()
                skip = torch.from_numpy(
                    (np.random.default_rng(m).random((nt, kp // 128)) < 0.4)
                    .astype(np.int32)).cuda()
                for name, sk in (("rand", skip),
                                 ("zero", torch.zeros_like(skip))):
                    o = llp.lloyd_step_pruned(xp, cp, cn, xn, sk, plan.m,
                                              **tiles)
                    upd = o[2:5] if len(o) == 6 else o[2:4]
                    put(f"{key}/pruned_{name}", o[0], o[1], o[-1],
                        *_sums(up, upd, nt))
                if dt != torch.float32 and k == 200:
                    xb = torch.stack([xp, xp.flip(0), xp * 2]).contiguous()
                    cb = torch.stack([cp, cp.flip(0), cp]).contiguous()
                    cnb = (cb.float() ** 2).sum(2)
                    cnb[:, k:] = torch.inf
                    b = ll.lloyd_step_batched_entries(xb, cb, cnb, plan.m,
                                                      **tiles)
                    put(f"{key}/batched", b[0], b[1],
                        *_sums(up, b[2:5], nt))
    torch.save(out, path)
    print(f"saved {len(out)} outputs to {path}")


def compare(a_path: str, b_path: str) -> int:
    import torch
    a, b = torch.load(a_path), torch.load(b_path)
    bad = sorted(set(a) ^ set(b))
    for key in sorted(set(a) & set(b)):
        x, y = a[key], b[key]
        if x.dtype.is_floating_point:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.shape != y.shape or not torch.equal(x, y):
            bad.append(key)
    for key in bad:
        print(f"differs: {key}")
    print(f"{len(a)} / {len(b)} outputs, {len(bad)} differ")
    return 1 if bad else 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "save":
        save(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
