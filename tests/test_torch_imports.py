"""The port stands alone: importing every ``repro_torch`` module loads
neither ``jax`` nor anything of the reference package ``repro``, and the
default device is the card, with no silent fall back to the CPU (the
Weaver, the LM and SASRec servers, model initialisation)."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = textwrap.dedent("""
    import importlib, pathlib, sys
    import repro_torch
    root = pathlib.Path(repro_torch.__file__).parent
    names = sorted(
        ".".join(("repro_torch",) + p.relative_to(root).with_suffix("")
                 .parts).removesuffix(".__init__")
        for p in root.rglob("*.py"))
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "repro" or m.startswith("repro."))
    print("MODULES", len(names))
    print("NAMES", " ".join(names))
    print("LEAKED", leaked)
    import torch
    from repro_torch.core import Weaver, WeaverConfig
    if not torch.cuda.is_available():
        try:
            Weaver(WeaverConfig())
        except RuntimeError as e:
            print("NO_CUDA_RAISES", 'device="cpu"' in str(e))
        else:
            print("NO_CUDA_RAISES", False)
    Weaver(WeaverConfig(device="cpu"))
    print("CPU_OK")
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import sasrec, transformer
    from repro_torch.runtime import LMServer, RecServer
    lm = reduced_config(get_arch("gemma3-1b"))
    rec = reduced_config(get_arch("sasrec"))
    servers = {
        "LMServer": lambda: LMServer(transformer.init_params(
            lm, device="cpu"), lm, batch=2, max_len=8),
        "RecServer": lambda: RecServer(sasrec.init_params(
            rec, device="cpu"), rec),
        "init_params": lambda: transformer.init_params(lm),
    }
    if not torch.cuda.is_available():
        for name, make in servers.items():
            try:
                make()
            except RuntimeError as e:
                print("NO_CUDA_RAISES", name, 'device="cpu"' in str(e))
            else:
                print("NO_CUDA_RAISES", name, False)
""")


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    n_modules = int(out.split("MODULES ")[1].split()[0])
    assert n_modules >= 79, out
    names = set(out.split("NAMES ")[1].split("\n")[0].split())
    assert {"repro_torch.runtime.server", "repro_torch.core.bsp",
            "repro_torch.core.twopl", "repro_torch.launch.serve",
            "repro_torch.examples.common", "repro_torch.examples.quickstart",
            "repro_torch.examples.social_serve",
            "repro_torch.examples.coingraph", "repro_torch.models.moe",
            "repro_torch.optim.compress", "repro_torch.checkpoint.mvckpt",
            "repro_torch.runtime.trainer", "repro_torch.launch.train",
            "repro_torch.examples.train_lm",
            "repro_torch.configs.moonshot_v1_16b_a3b",
            "repro_torch.configs.qwen3_moe_235b_a22b", "repro_torch.dist",
            "repro_torch.dist.sharding", "repro_torch.dist.collectives",
            "repro_torch.launch.mesh"} <= names, out
    assert "LEAKED []" in out, out
    assert "False" not in out.split("LEAKED")[1], out
    assert out.count("NO_CUDA_RAISES") in (0, 4), out
    assert "CPU_OK" in out, out
