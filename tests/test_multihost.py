"""Multi-host initialization exercised for real (SURVEY.md §4): two spawned
processes rendezvous through jax.distributed.initialize on the CPU backend,
run a cross-process psum, and the timeout path fails fast with the
diagnostic RuntimeError."""
import os
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import sys
    import jax
    from uob_raytracer_tpu.parallel import initialize_multihost

    pid, port = int(sys.argv[1]), sys.argv[2]
    ok = initialize_multihost(coordinator=f"127.0.0.1:{port}",
                              num_processes=2, process_id=pid, timeout_s=60)
    assert ok, "expected multi-host mode"
    assert jax.process_count() == 2
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    devs = jax.devices()
    mesh = Mesh(np.asarray(devs).reshape(-1), ("dp",))
    f = shard_map(lambda x: jax.lax.psum(x, "dp"), mesh=mesh,
                  in_specs=P("dp"), out_specs=P())
    n = len(devs)
    x = jnp.arange(n, dtype=jnp.float32)
    y = float(np.asarray(jax.device_get(f(x)))[0])
    assert y == float(x.sum()), (y, float(x.sum()))
    print(f"OK process={jax.process_index()} devices={n} psum={y}")
""")

E2E_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    import jax.numpy as jnp

    from uob_raytracer_tpu import RenderConfig, cornell_box
    from uob_raytracer_tpu.parallel import (global_mesh, initialize_multihost,
                                            render_image_sharded, train_step)
    from uob_raytracer_tpu.render import render_image

    pid, port = int(sys.argv[1]), sys.argv[2]
    assert initialize_multihost(coordinator=f"127.0.0.1:{port}",
                                num_processes=2, process_id=pid,
                                timeout_s=60)
    assert jax.process_count() == 2
    mesh = global_mesh()                  # dp = 4 (2 hosts x 2 devices each)
    n_dp = mesh.shape["dp"]
    cfg = RenderConfig(width=32, height=4 * n_dp, aa_x=2, aa_y=2,
                       shadow_samples=2, bounces=2)
    # numpy leaves: identical on every process, auto-replicated over the
    # global mesh (committed jnp arrays would be process-local placements)
    scene = cornell_box(as_numpy=True)

    # --- sharded render spanning both processes == local unsharded render ---
    img = jax.jit(lambda s: render_image_sharded(s, cfg, mesh))(scene)
    ref = np.asarray(jax.jit(
        lambda s: render_image(s, cfg, backend="jnp"))(scene))
    rows = cfg.height // n_dp
    assert img.addressable_shards, "process owns no image shards"
    for shard in img.addressable_shards:
        r0 = shard.index[0].start or 0
        np.testing.assert_allclose(np.asarray(shard.data),
                                   ref[r0:r0 + rows], rtol=1e-5, atol=1e-6)

    # --- one training step across processes == the unsharded step ---
    target = ref * np.float32(0.5)
    out = train_step(scene, target, cfg, mesh, lr=1e-3)

    def loss_fn(s):
        d = render_image(s, cfg, backend="jnp") - target
        return jnp.mean(jnp.square(d))

    loss_ref, grads = jax.jit(jax.value_and_grad(loss_fn))(scene)
    got_loss = float(np.asarray(out.loss.addressable_shards[0].data))
    np.testing.assert_allclose(got_loss, float(loss_ref), rtol=1e-5)
    for name in ("tri_v0", "tri_rgb", "light_pos", "yaw"):
        want = (np.asarray(getattr(scene, name))
                - np.float32(1e-3) * np.asarray(getattr(grads, name)))
        got = np.asarray(
            getattr(out.scene, name).addressable_shards[0].data)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-7)

    print(f"E2E-OK process={jax.process_index()}")
""")

ERROR_WORKER = textwrap.dedent("""
    from uob_raytracer_tpu.parallel import initialize_multihost
    try:
        initialize_multihost(coordinator="127.0.0.1:9", num_processes=2,
                             process_id=7, timeout_s=5)   # invalid id
    except RuntimeError as e:
        assert "rendezvous failed" in str(e), e
        print("ERROR-OK")
        raise SystemExit(7)
    raise SystemExit(1)
""")

TIMEOUT_WORKER = textwrap.dedent("""
    from uob_raytracer_tpu.parallel import initialize_multihost
    initialize_multihost(coordinator="127.0.0.1:{port}", num_processes=2,
                         process_id=1, timeout_s=8)
    raise SystemExit(1)   # must not get here: the coordinator is absent
""")


def _env():
    env = dict(os.environ)
    # A fresh CPU-backend interpreter: jax.distributed.initialize runs
    # before any backend initialization.
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_rendezvous_and_psum(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = [subprocess.Popen([sys.executable, str(script), str(i),
                               str(port)],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=180)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
        assert "OK process=" in out


@pytest.mark.slow
def test_two_process_render_and_train_step(tmp_path):
    """End-to-end across the two-process mesh: two processes (2 virtual CPU
    devices each) build a global dp=4 mesh, run ``render_image_sharded`` and
    one ``train_step``, and each asserts its addressable shards equal the
    single-process unsharded computation (the composition VERDICT r2 called
    untested)."""
    port = _free_port()
    script = tmp_path / "e2e_worker.py"
    script.write_text(E2E_WORKER)
    procs = [subprocess.Popen([sys.executable, str(script), str(i),
                               str(port)],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
        assert "E2E-OK" in out


def test_rendezvous_error_raises_runtime_error(tmp_path):
    """A catchable initialize failure surfaces as the module's diagnostic
    RuntimeError (multihost.py's except branch)."""
    script = tmp_path / "error_worker.py"
    script.write_text(ERROR_WORKER)
    p = subprocess.run([sys.executable, str(script)], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 7, p.stdout + p.stderr
    assert "ERROR-OK" in p.stdout


def test_rendezvous_timeout_fails_fast(tmp_path):
    """A missing coordinator kills the worker within the deadline — the
    fail-fast behavior itself. (The coordination client aborts the process
    at FATAL severity on DEADLINE_EXCEEDED rather than raising, so the
    observable contract is a nonzero exit with the deadline diagnostic.)"""
    script = tmp_path / "timeout_worker.py"
    script.write_text(TIMEOUT_WORKER.format(port=_free_port()))
    p = subprocess.run([sys.executable, str(script)], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0, p.stdout + p.stderr
    out = p.stdout + p.stderr
    assert "DEADLINE_EXCEEDED" in out or "Deadline Exceeded" in out or \
        "rendezvous failed" in out, out
