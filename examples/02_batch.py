"""Batched alignment: buckets compile once, pairs stream through the device
fill (the CUDA kernel on a GPU, the scan path on the CPU)."""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# honor JAX_PLATFORMS=cpu through jax.config as well (see tests/conftest.py)
if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
    import jax
    jax.config.update("jax_platforms", "cpu")

import smithwaterman_tpu as swt
from smithwaterman_tpu.utils.metrics import StatsCollector

pairs = [("HEAGAWGHEE", "PAWHEAE"), ("MKVSEAAL", "MKVSEAL"),
         ("WWWPPPGGG", "WWWGGG")] * 10
ba = swt.BatchAligner(mode=swt.LOCAL)
ba.stats = StatsCollector()
results = ba.align_pairs(pairs)
print("first:", results[0].score, results[0].aligned1)
print("metrics:", ba.stats.report())
