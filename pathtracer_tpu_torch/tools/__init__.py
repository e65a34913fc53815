"""Tools of the port: the albedo fit
(`python -m pathtracer_tpu_torch.tools.fit_albedo`) and the IOR fit
(`python -m pathtracer_tpu_torch.tools.fit_ior`), the counterparts of the
repo's tools/fit_albedo.py and tools/fit_ior.py, which take their gradient
through `utils/grad.value_and_grad`; one rank of a multi-process render
(`python -m pathtracer_tpu_torch.tools.multihost_worker`, the counterpart of
tools/multihost_worker.py); the multi-process render on several cards
against the single-process one (`python -m
pathtracer_tpu_torch.tools.multicard`); and the full-scale golden parity
(`python -m pathtracer_tpu_torch.tools.golden_parity`), the per-stage
timings (`python -m pathtracer_tpu_torch.tools.perfstats`) and the terminal
viewer (`python -m pathtracer_tpu_torch.tools.viewer`), the counterparts of
the repo's tools/golden_parity.py, tools/perfstats.py and viewer.py; and
the benchmark entry points, the headline line (`python -m
pathtracer_tpu_torch.tools.bench`) and the reference's measurement matrix
(`python -m pathtracer_tpu_torch.tools.bench_suite`), the counterparts of
the repo's bench.py and tools/bench_suite.py.
"""
