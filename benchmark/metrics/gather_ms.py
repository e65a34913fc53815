"""Mean ms of a chunk's fetch_image on rank 0 (the all-gather of the image
and its conversion to the host image), synchronized."""


def read(out, cell):
    g = out.spans.get("gather_s")
    return 1000.0 * sum(g) / len(g) if g else None
