"""The torch port stands alone: importing every module of ``repro_torch``
(and ``chip_smoke.py`` as a module, without running it) loads neither
``jax`` nor anything of the JAX package ``repro``."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_port_imports_no_jax_and_no_repro():
    body = textwrap.dedent("""
        import importlib, importlib.util, pkgutil, sys
        import repro_torch
        names = ["repro_torch"] + [
            m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      "chip_smoke.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        for need in ("kernels.ops", "kernels.gram", "kernels.cholesky",
                     "kernels.ngd_apply", "core.solvers", "core.pytree",
                     "core.device", "optim", "optim.ngd", "optim.scores",
                     "optim.adamw", "optim.schedules", "serve.server",
                     "kernels.cholupdate", "curvature.streaming",
                     "curvature.cache", "curvature.audit", "tenants.delta",
                     "tenants.manager",
                     "kernels.flash_attention", "models", "models.config",
                     "models.layers", "models.lm", "models.api",
                     "models.encdec", "configs.whisper_base",
                     "configs.pixtral_12b", "configs",
                     "configs.shapes", "configs.llama32_3b",
                     "configs.llama3_8b", "configs.gemma2_2b",
                     "configs.gemma2_9b", "data", "data.pipeline", "launch",
                     "launch.train", "launch.trainer", "serve.main",
                     "serve.__main__", "launch.supervisor", "checkpoint",
                     "checkpoint.checkpoint", "checkpoint.fleet",
                     "serve.journal", "obs", "obs.metrics", "obs.trace",
                     "obs.export", "obs.health", "obs.profile",
                     "obs.recorder", "obs.forensics", "launch.mesh",
                     "core.distributed", "dist", "dist.state",
                     "dist.cholupdate", "dist.server", "optim.hybrid",
                     "optim.compress", "fleet", "fleet.wire",
                     "fleet.gossip", "fleet.ring", "fleet.dispatcher",
                     "fleet.worker", "fleet.__main__"):
            assert "repro_torch." + need in names, need
        print(len(names))
    """)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    r = subprocess.run([sys.executable, "-c", body], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert int(r.stdout.strip().splitlines()[-1]) >= 90
