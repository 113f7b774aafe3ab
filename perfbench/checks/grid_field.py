"""The grid call's three fields at every node, held against the reference
sibson field: the interior nodes, the nodes on the grid's faces, edges and
corners (the ones the repair serves), and the widest gap anywhere."""

from perfbench.lib import checking as ck


def numbers(ctx, dataset, outputs):
    u, v, w = outputs["interpolate_field"]
    want = ck.grid_reference(ctx, dataset).double()
    got = ck.as_field((u, v, w), ctx.device)
    face = ck.face_nodes(want.shape[1:], ctx.device)
    return {"field_l2": ck.rel_l2(got, want, ~face),
            "edge_l2": ck.rel_l2(got, want, face),
            "field_gap": ck.gap(got, want, face | ~face)}
