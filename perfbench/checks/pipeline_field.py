"""The porous pipeline's field before cleaning, held against the
reference pipeline on the same raw inputs: the grid's fluid mask node for
node, exact zeros in solid (in every field the result returns), and the
interpolated field at the fluid nodes (all of them, those with a solid
face neighbour, those on the domain's faces), which carries every
threshold and kNN-MAD decision and every boundary particle."""

from perfbench.lib import checking as ck


def numbers(ctx, dataset, outputs):
    import torch
    res = outputs["run_pipeline"]
    ref = ck.porous_reference(ctx, dataset)
    mask = torch.as_tensor(ref["mask"], device=ctx.device)
    got_mask = torch.as_tensor(res.mask, device=ctx.device)
    before = ((res.u_init, res.v_init, res.w_init) if res.u_init is not None
              else (res.u, res.v, res.w))
    fields = [res.u, res.v, res.w]
    if res.u_init is not None:
        fields += [res.u_init, res.v_init, res.w_init]
    solid = ~mask
    nonzero = sum(int(torch.count_nonzero(
        torch.as_tensor(f, device=ctx.device)[solid])) for f in fields)
    got = ck.as_field(before, ctx.device)
    want = ref["field"].double()
    return {
        "mask_diff": int((got_mask != mask).sum()),
        "solid_nonzero": nonzero,
        "field_l2": ck.rel_l2(got, want, mask),
        "wall_l2": ck.rel_l2(got, want, ck.wall_nodes(mask)),
        "edge_l2": ck.rel_l2(got, want, mask & ck.face_nodes(mask.shape,
                                                             ctx.device)),
        "field_gap": ck.gap(got, want, mask),
    }
