"""Device kernels an iteration in the traced sub-window (copies, fills and
range spans left out)."""


def read(out, cell):
    t = out.trace
    if not t or not t["n_kernels"]:
        return None
    return t["n_kernels"] / t["iterations"]
