"""Mean host ms a displayed frame from the render's synchronize to the
uint8 image (lanes_to_image and to_uint8)."""


def read(out, cell):
    host = out.spans.get("display_host_s")
    return 1000.0 * sum(host) / len(host) if host else None
