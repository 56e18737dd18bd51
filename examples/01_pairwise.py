"""Single-pair alignment in all three modes (EMBOSS water/needle semantics)."""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# honor JAX_PLATFORMS=cpu through jax.config as well (see tests/conftest.py)
if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
    import jax
    jax.config.update("jax_platforms", "cpu")

import smithwaterman_tpu as swt

s1 = "HEAGAWGHEE"
s2 = "PAWHEAE"
for mode, name in [(swt.LOCAL, "local (water)"),
                   (swt.GLOCAL, "glocal (needle)"),
                   (swt.GLOBAL, "global (needle -endweight)")]:
    r = swt.Aligner(mode=mode).align(s1, s2)
    print(f"{name}: score={r.score}")
    print(f"  {r.aligned1}")
    print(f"  {r.aligned2}")
