"""Tools of the port: the albedo fit
(`python -m pathtracer_tpu_torch.tools.fit_albedo`) and the IOR fit
(`python -m pathtracer_tpu_torch.tools.fit_ior`), the counterparts of the
repo's tools/fit_albedo.py and tools/fit_ior.py, which take their gradient
through `utils/grad.value_and_grad`; one rank of a multi-process render
(`python -m pathtracer_tpu_torch.tools.multihost_worker`, the counterpart of
tools/multihost_worker.py); and the multi-process render on several cards
against the single-process one (`python -m
pathtracer_tpu_torch.tools.multicard`).
"""
