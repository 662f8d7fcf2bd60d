"""Multi-process rendering on torch.distributed: two CPU processes on
gloo through the port's launcher (``python -m
radish_pt_tpu_torch.parallel.multihost_render``), each rendering its tile
of cornell 32x32 at 3 spp, depth 3, and gathering the image.

Tolerances: against the port's single-device accumulation, none (bit for
bit: the tiles are the frame's lanes, and the gather only concatenates);
against the JAX package's single-device accumulation (its brute-force
engine; the port's own build runs the Plücker sweeps), the bound on the
mean of tests/test_torch_pathtrace.py's Plücker parity test (< 1e-3).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.join(os.path.dirname(__file__), "..")
SCENE = os.path.join(REPO, "scenes", "cornell_box.txt")
RES, SPP, DEPTH = 32, 3, 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_render_matches_single_device(tmp_path):
    out = str(tmp_path / "mh.npy")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    args = [sys.executable, "-m", "radish_pt_tpu_torch.parallel.multihost_render", SCENE,
            "--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes", "2",
            "--device", "cpu", "--res", str(RES), str(RES), "--spp", str(SPP),
            "--depth", str(DEPTH), "--out-npy", out]
    p1 = subprocess.Popen(args + ["--process-id", "1"], cwd=REPO, env=env,
                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        p0 = subprocess.run(args + ["--process-id", "0"], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=120)
        err1 = p1.communicate(timeout=60)[1].decode()
    finally:
        if p1.poll() is None:
            p1.kill()
            p1.wait()
    assert p0.returncode == 0, p0.stderr[-2000:]
    assert p1.returncode == 0, err1[-2000:]
    assert "Mesh(tile=2, sample=1, tiles 0..0" in p0.stdout
    got = np.load(out)

    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.scene.build import load_scene

    ds, cam, _ = load_scene(SCENE, device="cpu")
    cam = cam.replace(width=RES, height=RES)
    acc = torch.zeros((RES * RES, 3))
    for i in range(SPP):
        acc = pt.accumulate(acc, pt.scrub_and_compress(sum(pt.path_trace(ds, cam, i, DEPTH))),
                            i)
    want = acc.numpy().reshape(RES, RES, 3)
    assert got.shape == want.shape and np.array_equal(got, want)

    import jax
    import jax.numpy as jnp

    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu.scene.build import load_scene as jload

    jds, jcam, _ = jload(SCENE)
    jcam = jcam.replace(width=RES, height=RES)
    f = jax.jit(jpt.path_trace, static_argnames=("max_depth",))
    jacc = jnp.zeros((RES * RES, 3))
    for i in range(SPP):
        d, ind = f(jds, jcam, i, DEPTH)
        jacc = jpt.accumulate(jacc, jpt.scrub_and_compress(d + ind), i)
    ref = np.asarray(jacc).reshape(RES, RES, 3)
    assert np.abs(got - ref).mean() < 1e-3 and ref.mean() > 0.05
