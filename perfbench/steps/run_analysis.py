"""``ptv_interpolation_tpu_torch.analyze.run_analysis`` on the field the
previous step returned, with the mix's analysis flags; no file written."""


def prepare(ctx, params):
    from ptv_interpolation_tpu_torch.analyze import AnalyzeConfig
    flags = {"input": "", "basename": "perfbench", "save_tiffs": False,
             "output_npz": None, "verbose": False}
    flags.update({k: v for k, v in params.items() if k != "step"})
    return AnalyzeConfig(**flags)


def run(ctx, state, dataset, carry, timings):
    from ptv_interpolation_tpu_torch.analyze import run_analysis
    results, _ = run_analysis(state, field=carry, timings=timings,
                              device=ctx.device)
    return results
