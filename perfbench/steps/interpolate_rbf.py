"""One local-RBF grid call: ``ptv_interpolation_tpu_torch.interpolate.
interpolate_field(points, values, grid, method="rbf", rbf_neighbors=k,
rbf_kernel=…, smoothing=…, epsilon=…)`` from host arrays to the three
fields on the device, ended by ``torch.cuda.synchronize()``.

``prepare`` also has each profiled stretch leave the device time under
the port's spans (``lib/span_device.py``), which the ``rbf_*`` metrics
read."""


def prepare(ctx, params):
    from perfbench.lib import span_device
    from ptv_interpolation_tpu_torch.grid import create_grid
    span_device.install()
    cfg = ctx.config
    grid = create_grid(tuple(tuple(b) for b in cfg["grid_bounds"]),
                       int(cfg["grid_n"]))
    kwargs = {"method": cfg["method"],
              "rbf_neighbors": int(cfg["rbf_neighbors"]),
              "rbf_kernel": cfg["rbf_kernel"],
              "smoothing": float(cfg["smoothing"]),
              "epsilon": float(cfg["epsilon"])}
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
    """The reference local-RBF field at ``dtype`` in the program's place."""
    from perfbench.lib.rbf_grid import reference
    ref = reference(ctx, dataset, dtype)
    return tuple(ref[c].float() for c in range(3))
