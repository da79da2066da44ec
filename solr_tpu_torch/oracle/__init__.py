"""CPU reference oracle (pure NumPy, float64; counterpart of
solr_tpu/oracle).

A slow, simple, independently implemented tracer whose images the
renderer must match (BASELINE config #1's CPU reference).  It takes this
package's Scene, Camera and RenderConfig and computes in numpy alone.
"""

from solr_tpu_torch.oracle.cpu_tracer import oracle_render

__all__ = ["oracle_render"]
