"""Interactive progressive viewer for the port (the counterpart of the
repo's viewer.py): the reference app's interactivity (main.cpp:488-562)
without a GL window.

LIVE mode (the default on a TTY): a raw-terminal (termios cbreak) keypress
loop. Keys act at once, with no enter, and the render refines between
keystrokes as the reference's per-frame loop does (main.cpp:454-472): each
pass polls input, restarts accumulation if the camera changed (camchanged,
main.cpp:423-452), runs a chunk of iterations and redraws. The image is
drawn in the terminal (kitty graphics protocol, iTerm2 inline image, or
truecolor half-block ANSI cells, detected) and mirrored to a PNG.

Keys (reference bindings, main.cpp:488-562):
  a/d     orbit left/right   (left-drag theta)
  w/x     orbit up/down      (left-drag phi)
  q/e     zoom in/out        (right-drag)
  i/j/k/l pan lookAt         (middle-drag)
  r       re-center lookAt   (SPACE key equivalent)
  s       save a timestamped PNG (S key)
  ESC     save + exit

TYPED mode (--typed, or when stdin is not a TTY): the same commands typed
and entered, preview only through the rewritten PNG; the scriptable mode.

Usage: python -m pathtracer_tpu_torch.tools.viewer scenes/cornell.json
       [--res 256] [--out live.png] [--display auto|kitty|iterm2|ansi|file]
       [--typed] [--bvh IMPL] [--device cuda]
"""
from __future__ import annotations

import argparse
import base64
import os
import select
import sys
import time

import numpy as np

from ..io.image import png_bytes
from ..ops.intersect import BVH_IMPLS

ORBIT_STEP = 0.15    # radians a key turns the orbit
PAN_STEP = 0.5       # scene units a key zooms or pans
MIN_THETA, MAX_THETA, MIN_ZOOM = 1e-3, 3.14, 0.1


# ---------------------------------------------------------------------------
# Terminal display backends
# ---------------------------------------------------------------------------

def detect_display() -> str:
    term = os.environ.get("TERM", "")
    if os.environ.get("KITTY_WINDOW_ID") or "kitty" in term:
        return "kitty"
    if os.environ.get("ITERM_SESSION_ID") or "iTerm" in os.environ.get(
            "TERM_PROGRAM", ""):
        return "iterm2"
    if sys.stdout.isatty():
        return "ansi"
    return "file"


def show_kitty(img8) -> None:
    """Kitty graphics protocol: transmit and display a PNG in place."""
    payload = base64.standard_b64encode(png_bytes(img8)).decode()
    out = sys.stdout
    out.write("\033[H")
    first = True
    while payload:
        chunk, payload = payload[:4096], payload[4096:]
        m = 1 if payload else 0
        ctrl = f"a=T,f=100,m={m}" if first else f"m={m}"
        out.write(f"\033_G{ctrl};{chunk}\033\\")
        first = False
    out.write("\n")
    out.flush()


def show_iterm2(img8) -> None:
    payload = base64.standard_b64encode(png_bytes(img8)).decode()
    sys.stdout.write(f"\033[H\033]1337;File=inline=1:{payload}\a\n")
    sys.stdout.flush()


def show_ansi(img8, max_cols: int = 0) -> None:
    """Truecolor half-block cells: 2 vertical pixels a character row, in
    any terminal without a graphics protocol."""
    h, w = img8.shape[:2]
    if not max_cols:
        try:
            tw, th = os.get_terminal_size()
        except OSError:
            tw, th = 80, 24
        max_cols = max(16, min(tw - 2, (th - 3) * 2 * w // max(h, 1)))
    step = max(1, (w + max_cols - 1) // max_cols)
    small = img8[::step, ::step]
    if small.shape[0] % 2:
        small = small[:-1]
    top, bot = small[0::2], small[1::2]
    lines = ["\033[H"]
    for rt, rb in zip(top, bot):
        row = []
        for (r1, g1, b1), (r2, g2, b2) in zip(rt, rb):
            row.append(f"\033[38;2;{r1};{g1};{b1}m"
                       f"\033[48;2;{r2};{g2};{b2}m▀")
        lines.append("".join(row) + "\033[0m")
    sys.stdout.write("\n".join(lines) + "\n")
    sys.stdout.flush()


def show(display: str, img8) -> None:
    if display == "kitty":
        show_kitty(img8)
    elif display == "iterm2":
        show_iterm2(img8)
    elif display == "ansi":
        show_ansi(img8)


# ---------------------------------------------------------------------------
# Raw-terminal key input
# ---------------------------------------------------------------------------

class RawKeys:
    """cbreak-mode stdin with a non-blocking drain (restored on exit)."""

    def __enter__(self):
        import termios
        import tty
        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        return self

    def __exit__(self, *exc):
        import termios
        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def drain(self) -> str:
        """All pending keypresses (empty string if none)."""
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            keys.append(sys.stdin.read(1))
        return "".join(keys)


# ---------------------------------------------------------------------------
# Camera keys
# ---------------------------------------------------------------------------

def apply_key(cmd: str, zoom: float, theta: float, phi: float,
              look_at: np.ndarray, home_look_at: np.ndarray):
    """One key -> (action, zoom, theta, phi, look_at), main.cpp:488-562's
    semantics. action is "moved", "save", "quit" or "" (an unbound key,
    nothing changed); look_at is a new array."""
    look_at = np.array(look_at, dtype=np.float64)
    if cmd == "a":
        phi += ORBIT_STEP
    elif cmd == "d":
        phi -= ORBIT_STEP
    elif cmd == "w":
        theta = max(MIN_THETA, theta - ORBIT_STEP)
    elif cmd == "x":
        theta = min(MAX_THETA, theta + ORBIT_STEP)
    elif cmd == "q":
        zoom = max(MIN_ZOOM, zoom - PAN_STEP)
    elif cmd == "e":
        zoom += PAN_STEP
    elif cmd == "i":
        look_at[1] += PAN_STEP
    elif cmd == "k":
        look_at[1] -= PAN_STEP
    elif cmd == "j":
        look_at[0] -= PAN_STEP
    elif cmd == "l":
        look_at[0] += PAN_STEP
    elif cmd == "r":
        look_at = np.array(home_look_at, dtype=np.float64)
    elif cmd == "s":
        return "save", zoom, theta, phi, look_at
    elif cmd in ("\x1b", "quit", "exit"):
        return "quit", zoom, theta, phi, look_at
    else:
        return "", zoom, theta, phi, look_at
    return "moved", zoom, theta, phi, look_at


# ---------------------------------------------------------------------------
# Viewer
# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.viewer")
    ap.add_argument("scene")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--out", type=str, default="live.png",
                    help="continuously-updated preview PNG")
    ap.add_argument("--spp-per-step", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--display", default="auto",
                    choices=["auto", "kitty", "iterm2", "ansi", "file"])
    ap.add_argument("--typed", action="store_true",
                    help="typed-command mode (no raw terminal)")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="exit after N refine steps (smoke testing)")
    ap.add_argument("--bvh", choices=BVH_IMPLS, default=None,
                    help="mesh intersector (default: the loader's pick)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from ..engine.wavefront import lanes_to_image, render_chunk, zero_accum
    from ..io.image import reference_style_name, save_png, to_uint8
    from ..scene.loader import derive_camera, load_scene, orbit_camera
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    overrides = {"RES": [args.res, args.res]}
    if args.depth:
        overrides["DEPTH"] = args.depth
    scene, settings = load_scene(args.scene, device, overrides=overrides,
                                 bvh_impl=args.bvh)

    display = detect_display() if args.display == "auto" else args.display
    typed = args.typed or not sys.stdin.isatty()

    # orbit state from the loaded camera (main.cpp:359-381)
    cam = scene.camera
    pos = cam.position.double().cpu().numpy()
    look_at = np.asarray(settings.look_at, dtype=np.float64)
    offset = pos - look_at
    zoom = float(np.linalg.norm(offset))
    theta = float(np.arccos(np.clip(offset[1] / max(zoom, 1e-9), -1, 1)))
    phi = float(np.arctan2(offset[0], offset[2]))
    cam_dict = derive_camera(pos, look_at, cam.up.double().cpu().numpy(),
                             settings.fovy_deg, settings.width,
                             settings.height, float(cam.focal_distance),
                             float(cam.lens_radius))
    home_look_at = look_at.copy()

    def rebuild_camera():
        """The camera tensors from (zoom, theta, phi, look_at), written in
        place: the compiled frame's graph reads them where they are, so a
        move needs no new capture."""
        new_cam = orbit_camera(cam_dict, zoom, theta, phi, look_at)
        for k in ("position", "view", "up", "right"):
            getattr(scene.camera, k).copy_(torch.as_tensor(
                new_cam[k], dtype=torch.float32))

    accum = zero_accum(settings, device)
    iteration = 0
    last_ms = 0.0

    def refine():
        nonlocal accum, iteration, last_ms
        t0 = time.perf_counter()
        accum = render_chunk(scene, settings, accum, iteration + 1,
                             args.spp_per_step, args.seed, True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        iteration += args.spp_per_step
        img = lanes_to_image(accum * (1.0 / iteration), settings)
        last_ms = (time.perf_counter() - t0) * 1e3 / args.spp_per_step
        return img

    def restart():
        nonlocal accum, iteration
        accum = zero_accum(settings, device)
        iteration = 0

    def key(cmd: str) -> str:
        nonlocal zoom, theta, phi, look_at
        act, zoom, theta, phi, look_at = apply_key(cmd, zoom, theta, phi,
                                                   look_at, home_look_at)
        return act

    def save_timestamped(img):
        out = reference_style_name(settings.image_name, iteration)
        save_png(img, out)
        return out

    rebuild_camera()

    if typed:
        print(__doc__.split("Usage:")[0])
        img = refine()
        save_png(img, args.out)
        steps = 1
        while not (args.max_steps and steps >= args.max_steps):
            try:
                cmd = input("viewer> ").strip()
            except EOFError:
                cmd = "quit"
            act = key(cmd)
            if act == "quit":
                print(f"  saved {save_timestamped(img)}")
                return
            if act == "save":
                print(f"  saved {save_timestamped(img)}")
            elif act == "moved":
                rebuild_camera()
                restart()       # camchanged -> restart accumulation
            img = refine()
            save_png(img, args.out)
            steps += 1
            print(f"  {iteration} spp  ({last_ms:.1f} ms/frame)  "
                  f"-> {args.out}")
        return

    # LIVE raw-tty loop: poll keys -> (maybe) restart -> refine -> draw
    sys.stdout.write("\033[2J\033[H")   # clear once; frames repaint in place
    status = ""
    steps = 0
    with RawKeys() as keys:
        img = refine()
        while True:
            moved = done = False
            for cmd in keys.drain():
                act = key(cmd)
                if act == "quit":
                    done = True
                elif act == "save":
                    status = f"saved {save_timestamped(img)}"
                elif act == "moved":
                    moved = True
            if moved:
                rebuild_camera()
                restart()       # camchanged (main.cpp:423-452)
            img = refine()
            show(display, to_uint8(img))
            sys.stdout.write(
                f"\033[K{iteration:6d} spp  {last_ms:6.1f} ms/frame  "
                f"zoom {zoom:.1f}  [a/d w/x orbit, q/e zoom, ijkl pan, "
                f"r home, s save, ESC quit]  {status}\r")
            sys.stdout.flush()
            save_png(img, args.out)
            steps += 1
            if done or (args.max_steps and steps >= args.max_steps):
                print(f"\n  saved {save_timestamped(img)}")
                return


if __name__ == "__main__":
    main()
