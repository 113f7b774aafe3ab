"""The variationally cleaned field, held against the reference's own
cleaning (an f64 conjugate-gradient solve of ``(I + λ D̃ᵀD̃) U = U0``)
of the reference's own field before cleaning, at every fluid node."""

from perfbench.lib import checking as ck


def numbers(ctx, dataset, outputs):
    import torch
    res = outputs["run_pipeline"]
    ref = ck.porous_reference(ctx, dataset)
    mask = torch.as_tensor(ref["mask"], device=ctx.device)
    got = ck.as_field((res.u, res.v, res.w), ctx.device)
    want = ref["cleaned"].double()
    return {"clean_l2": ck.rel_l2(got, want, mask),
            "clean_gap": ck.gap(got, want, mask)}
