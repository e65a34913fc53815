"""The slowest rank's render seconds over the mean rank's, summed over the
window's chunks (each chunk's render_chunk_sharded up to its
synchronize)."""


def read(out, cell):
    r = out.spans.get("rank_render_s")
    if not r:
        return None
    return max(r) / (sum(r) / len(r))
