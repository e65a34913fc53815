"""PyTorch port, the terminal viewer (pathtracer_tpu_torch/tools/viewer.py),
on the CPU: the typed mode through a pipe and the live mode through a pty,
each in a subprocess run in a temporary directory (the timestamped save
lands in the working directory), as tests/test_viewer.py drives the repo's
viewer.py; the camera keys against the arithmetic of viewer.py's key
handler (hand-written expected values); png_bytes through load_png.
"""
import os
import re
import select
import subprocess
import sys
import time

import numpy as np
import pytest

from pathtracer_tpu_torch.io.image import load_png, png_bytes, save_png
from pathtracer_tpu_torch.scene.fixtures import REPO_ROOT, scene_path
from pathtracer_tpu_torch.tools import viewer

VIEWER = [sys.executable, "-m", "pathtracer_tpu_torch.tools.viewer"]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_viewer_typed_mode(tmp_path):
    out = tmp_path / "live.png"
    p = subprocess.run(
        VIEWER + [scene_path("cornell"), "--res", "32", "--device", "cpu",
                  "--typed", "--spp-per-step", "2", "--max-steps", "3",
                  "--out", str(out)],
        cwd=tmp_path, env=_env(), input="a\ns\n", capture_output=True,
        text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert load_png(str(out)).shape == (32, 32, 3)
    assert "saved" in p.stdout
    # the 'a' orbit restarts accumulation: the two typed steps print 2 then
    # 4 spp (without the restart they would print 4 then 6)
    assert re.findall(r"(\d+) spp", p.stdout) == ["2", "4"], \
        p.stdout[-2000:]
    saved = re.findall(r"saved (\S+samp\.png)", p.stdout)
    assert saved and (tmp_path / saved[0]).exists()


@pytest.mark.slow
def test_viewer_live_pty(tmp_path):
    pty = pytest.importorskip("pty")
    out = tmp_path / "live.png"
    env = _env()
    pid, fd = pty.fork()
    if pid == 0:  # child: exec the viewer on the pty
        os.chdir(tmp_path)
        os.execvpe(sys.executable,
                   VIEWER + [scene_path("cornell"), "--res", "32",
                             "--device", "cpu", "--display", "ansi",
                             "--spp-per-step", "2", "--max-steps", "6",
                             "--out", str(out)], env)
    buf = b""
    sent = False
    t0 = time.time()
    try:
        while time.time() - t0 < 300:
            r, _, _ = select.select([fd], [], [], 0.5)
            if r:
                try:
                    chunk = os.read(fd, 65536)
                except OSError:
                    break
                if not chunk:
                    break
                buf += chunk
                if not sent and b"spp" in buf:
                    os.write(fd, b"d")  # orbit right, no newline
                    sent = True
            done, _ = os.waitpid(pid, os.WNOHANG)
            if done:
                break
        else:
            os.kill(pid, 9)
            pytest.fail("viewer did not finish in time")
    finally:
        os.close(fd)
    assert sent, "never saw a frame status line"
    assert out.exists()
    assert b"\x1b[38;2;" in buf          # truecolor half-block cells drawn
    assert "▀".encode() in buf
    assert re.search(rb"saved (\S+samp\.png)", buf)


HOME = np.array([0.0, 5.0, 0.0])
START = (10.0, 1.0, 0.5, np.array([1.0, 5.0, -2.0]))   # zoom, theta, phi, at

# key -> (action, zoom, theta, phi, look_at) after START, by viewer.py's
# apply_key: orbit 0.15 rad, zoom / pan 0.5, theta in [1e-3, 3.14],
# zoom >= 0.1
EXPECTED = {
    "a": ("moved", 10.0, 1.0, 0.65, [1.0, 5.0, -2.0]),
    "d": ("moved", 10.0, 1.0, 0.35, [1.0, 5.0, -2.0]),
    "w": ("moved", 10.0, 0.85, 0.5, [1.0, 5.0, -2.0]),
    "x": ("moved", 10.0, 1.15, 0.5, [1.0, 5.0, -2.0]),
    "q": ("moved", 9.5, 1.0, 0.5, [1.0, 5.0, -2.0]),
    "e": ("moved", 10.5, 1.0, 0.5, [1.0, 5.0, -2.0]),
    "i": ("moved", 10.0, 1.0, 0.5, [1.0, 5.5, -2.0]),
    "k": ("moved", 10.0, 1.0, 0.5, [1.0, 4.5, -2.0]),
    "j": ("moved", 10.0, 1.0, 0.5, [0.5, 5.0, -2.0]),
    "l": ("moved", 10.0, 1.0, 0.5, [1.5, 5.0, -2.0]),
    "r": ("moved", 10.0, 1.0, 0.5, [0.0, 5.0, 0.0]),
    "s": ("save", 10.0, 1.0, 0.5, [1.0, 5.0, -2.0]),
    "\x1b": ("quit", 10.0, 1.0, 0.5, [1.0, 5.0, -2.0]),
    "quit": ("quit", 10.0, 1.0, 0.5, [1.0, 5.0, -2.0]),
    "exit": ("quit", 10.0, 1.0, 0.5, [1.0, 5.0, -2.0]),
    "z": ("", 10.0, 1.0, 0.5, [1.0, 5.0, -2.0]),
    "": ("", 10.0, 1.0, 0.5, [1.0, 5.0, -2.0]),
}


@pytest.mark.parametrize("cmd", list(EXPECTED))
def test_apply_key(cmd):
    zoom, theta, phi, at = START
    got = viewer.apply_key(cmd, zoom, theta, phi, at, HOME)
    want = EXPECTED[cmd]
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1:4], want[1:4], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[4], want[4], rtol=0, atol=1e-12)
    # the caller's arrays are not changed in place
    np.testing.assert_array_equal(at, [1.0, 5.0, -2.0])
    np.testing.assert_array_equal(HOME, [0.0, 5.0, 0.0])


def test_apply_key_clamps():
    at = np.zeros(3)
    assert viewer.apply_key("w", 1.0, 0.1, 0.0, at, at)[2] == 1e-3
    assert viewer.apply_key("x", 1.0, 3.1, 0.0, at, at)[2] == 3.14
    assert viewer.apply_key("q", 0.3, 1.0, 0.0, at, at)[1] == 0.1


def test_png_bytes_round_trip(tmp_path):
    img8 = np.random.default_rng(4).integers(0, 256, (9, 13, 3),
                                             dtype=np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(png_bytes(img8))
    np.testing.assert_array_equal(load_png(str(path)),
                                  img8 / np.float32(255.0))
    # save_png writes png_bytes of its clamped, mirrored image
    img = np.random.default_rng(5).uniform(-0.2, 1.2, (9, 13, 3))
    save_png(img, str(path))
    want = (np.clip(img, 0, 1) * 255).astype(np.uint8)[:, ::-1]
    assert path.read_bytes() == png_bytes(want)
