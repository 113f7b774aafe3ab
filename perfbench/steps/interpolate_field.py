"""One grid call: ``ptv_interpolation_tpu_torch.interpolate.interpolate_field``
from host arrays to the three fields on the device, ended by
``torch.cuda.synchronize()``."""


def prepare(ctx, params):
    from ptv_interpolation_tpu_torch.grid import create_grid
    cfg = ctx.config
    grid = create_grid(tuple(tuple(b) for b in cfg["grid_bounds"]),
                       int(cfg["grid_n"]))
    kwargs = {"method": cfg["method"],
              "sibson_neighbors": int(cfg["sibson_neighbors"]),
              "tau_mode": cfg["tau_mode"]}
    kwargs.update({k: v for k, v in params.items() if k != "step"})
    return grid, kwargs


def run(ctx, state, dataset, carry, timings):
    import torch
    from ptv_interpolation_tpu_torch.interpolate import interpolate_field
    grid, kwargs = state
    out = interpolate_field(dataset["points"], dataset["values"], grid,
                            device=ctx.device, **kwargs)
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.synchronize()
    return out


def control(ctx, state, dataset, carry, dtype):
    """The reference sibson field at ``dtype`` in the program's place."""
    from perfbench.lib.checking import grid_reference
    ref = grid_reference(ctx, dataset, dtype)
    return tuple(ref[c].float() for c in range(3))
