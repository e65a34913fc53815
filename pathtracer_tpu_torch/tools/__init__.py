"""Differentiable-rendering tools of the port, on one device: the albedo fit
(`python -m pathtracer_tpu_torch.tools.fit_albedo`) and the IOR fit
(`python -m pathtracer_tpu_torch.tools.fit_ior`), the counterparts of the
repo's tools/fit_albedo.py and tools/fit_ior.py. Both take their gradient
through `utils/grad.value_and_grad`.
"""
