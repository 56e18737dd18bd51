"""Resumable all-vs-all sweep producing a score matrix."""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# honor JAX_PLATFORMS=cpu through jax.config as well (see tests/conftest.py)
if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
    import jax
    jax.config.update("jax_platforms", "cpu")

import smithwaterman_tpu as swt
from smithwaterman_tpu.sweep import SweepConfig, score_matrix

seqs = [swt.SeqData(f"s{i}", "", s) for i, s in enumerate(
    ["HEAGAWGHEE", "PAWHEAE", "HEAGAWGHEF", "WWWPPP"])]
mat = score_matrix(seqs, None, swt.BatchAligner(mode=swt.LOCAL),
                   "/tmp/swt_sweep.jsonl", SweepConfig(chunk_pairs=3))
print(mat)
