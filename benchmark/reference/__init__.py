"""The plain reference path tracer of the benchmark.

An independent implementation, in plain PyTorch and NumPy, of what the
path tracer under test computes: the scene JSON, OBJ and MTL parsed again,
the camera and its orbit worked out again, the counter-based PCG hash
that keys every random number on (seed, iteration, depth, pixel), the
closest hit over boxes, spheres and triangles (triangles by brute force
over each cluster whose box the ray meets), and the BSDFs. It imports
nothing of the program (neither package of this repository) and takes
nothing the program made. Every float computation runs in the `dtype` it
is given: float32 is the reference, a lower one (bfloat16) is the control
that the comparison has to reject.
"""
