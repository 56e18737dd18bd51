"""Greedy clustering (CD-HIT-style), reference -cluster semantics."""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# honor JAX_PLATFORMS=cpu through jax.config as well (see tests/conftest.py)
if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
    import jax
    jax.config.update("jax_platforms", "cpu")

import smithwaterman_tpu as swt
from smithwaterman_tpu.cluster import greedy_cluster, write_cluster_outputs

seqs = [
    swt.SeqData("a", "", "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"),
    swt.SeqData("a_dup", "", "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"),
    swt.SeqData("a_sub", "", "MKTAYIAKQRQISFVKSHFSRQLEERL"),
    swt.SeqData("other", "", "PPPPPGGGGGPPPPPGGGGGPPPPPGGGGG"),
]
engine = swt.BatchAligner(mode=swt.LOCAL)
cluster_of, members, order = greedy_cluster(seqs, engine)
write_cluster_outputs("/tmp/swt_clusters.fas", order, cluster_of, members)
print(open("/tmp/swt_clusters.fas.clstr").read())
