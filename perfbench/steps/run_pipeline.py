"""One dataset through ``ptv_interpolation_tpu_torch.pipeline.run_pipeline``
from host arrays to the returned ``FieldResult`` of host numpy fields,
with the configuration's flags and the mix's overrides."""

import dataclasses


def prepare(ctx, params):
    from ptv_interpolation_tpu_torch.pipeline import PipelineConfig
    names = {f.name for f in dataclasses.fields(PipelineConfig)}
    flags = {k: v for k, v in ctx.config.items() if k in names}
    flags.update({k: v for k, v in params.items() if k in names})
    return PipelineConfig(**flags)


def run(ctx, state, dataset, carry, timings):
    from ptv_interpolation_tpu_torch.io import PointCloud
    from ptv_interpolation_tpu_torch.pipeline import run_pipeline
    return run_pipeline(state, cloud=PointCloud(dataset["points"],
                                                dataset["values"]),
                        mask_raw=dataset["fluid"], timings=timings,
                        device=ctx.device)


def control(ctx, state, dataset, carry, dtype):
    """The reference pipeline at ``dtype`` in the program's place, as the
    fields a ``FieldResult`` carries."""
    from types import SimpleNamespace

    from perfbench.reference import porous
    flags = dataclasses.asdict(state)
    ref = porous.run(flags, dataset["points"], dataset["values"],
                     dataset["fluid"], dtype, ctx.device,
                     clean=bool(flags["divergence_free"]))

    def host(t):
        return [a.float().cpu().numpy() for a in t]

    u, v, w = host(ref["field"])
    out = SimpleNamespace(mask=ref["mask"], u=u, v=v, w=w, u_init=None,
                          v_init=None, w_init=None)
    if ref["cleaned"] is not None:
        out.u_init, out.v_init, out.w_init = u, v, w
        out.u, out.v, out.w = host(ref["cleaned"])
    return out
