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

The mesh path's measurement tools, the counterparts of the repo's tools
of the same names (trace_stats: tools/xplane_stats.py), each on the CUDA
device unless `--device cpu`:
  python -m pathtracer_tpu_torch.tools.trace_stats      the in-frame split
      of device ms, host ms and launches by engine stage (torch.profiler);
  python -m pathtracer_tpu_torch.tools.sweep_mesh       one mesh
      intersection of a bounce-ray pool per configuration, and the
      ablation split;
  python -m pathtracer_tpu_torch.tools.profile_binned   the binned stages
      and every bin sort, by call site;
  python -m pathtracer_tpu_torch.tools.profile_binned2  the binned
      pipeline timed up to successive cut points;
  python -m pathtracer_tpu_torch.tools.diag_bins        distinct ids and
      support per stream block, per pass;
  python -m pathtracer_tpu_torch.tools.bench_sorts      the radix sort
      against torch.sort on material keys;
  python -m pathtracer_tpu_torch.tools.exp_r5           the bin-sort
      layouts (contig, sorts, diag);
  python -m pathtracer_tpu_torch.tools.exp_r5b          engine-level flag
      arms timed interleaved;
  python -m pathtracer_tpu_torch.tools.union_model      the packet walk's
      block-union cost model (NumPy);
  python -m pathtracer_tpu_torch.tools.sim_wide         the 8-wide walk's
      pop counts (NumPy).
"""
