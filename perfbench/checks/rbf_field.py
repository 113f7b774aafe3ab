"""The local-RBF grid call's three fields at every node, held against the
reference local RBF in float64: the interior nodes, the nodes on the
grid's faces, edges and corners (where a node's k-set most often reaches
past its block's region), and the widest gap anywhere."""

from perfbench.lib import checking as ck
from perfbench.lib.rbf_grid import reference


def numbers(ctx, dataset, outputs):
    u, v, w = outputs["interpolate_rbf"]
    want = reference(ctx, dataset).double()
    got = ck.as_field((u, v, w), ctx.device)
    face = ck.face_nodes(want.shape[1:], ctx.device)
    return {"field_l2": ck.rel_l2(got, want, ~face),
            "edge_l2": ck.rel_l2(got, want, face),
            "field_gap": ck.gap(got, want, face | ~face)}
