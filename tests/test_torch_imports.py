"""The port stands alone: importing every ``repro_torch`` module loads
neither ``jax`` nor anything of the reference package ``repro``, and the
default device is the card, with no silent fall back to the CPU."""

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
""")


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    n_modules = int(out.split("MODULES ")[1].split()[0])
    assert n_modules >= 28, out
    assert "LEAKED []" in out, out
    assert "NO_CUDA_RAISES False" not in out, out
    assert "CPU_OK" in out, out
