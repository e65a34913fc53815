"""Multi-device rendering of the port (the counterpart of
pathtracer_tpu/parallel/): the ray pool sharded over local shards or over
the ranks of a torch.distributed group (sharding.py, distributed.py), and a
dry run of one sharded forward chunk and albedo step (dryrun.py).
"""
