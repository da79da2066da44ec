"""Capacity and algorithm constants (counterpart of solr_tpu/constants.py).

The values are the reference's, so the two packages agree on every
epsilon, sentinel and parking spot.
"""

# Geometric epsilons (f32-safe).
RAY_EPS = 1e-4          # t_min for secondary rays / shadow ray offset
INTERSECT_EPS = 1e-8    # degenerate denominator guard
NORMAL_EPS = 1e-12      # normalization guard

# Pool padding: pools are padded to a multiple of this with inert entries
# (negative radius, degenerate triangle) that never hit.
PAD_ALIGN = 8

# Primitives per BVH leaf.
BVH_LEAF_SIZE = 8

# Primitives per packet block of a scene built with the defaults (the
# reference's SOLR_PACKET_BLOCK default).
DEFAULT_BLOCK = 256

# Pool codes, in the order traversal visits the pools (a tie across
# pools goes to the lower code).
POOL_SPHERE = 0
POOL_TRIANGLE = 1
POOL_CYLINDER = 2
POOL_ELLIPSOID = 3
POOL_PLANE = 4

# Reserved material conventions.
DEFAULT_MATERIAL = 0

# Far value used as "no hit" sentinel.
T_FAR = 3.0e38

# Dead-ray parking spot: far outside any scene so packet bundles of
# parked rays cull to zero candidate blocks.  Any ray whose origin x
# exceeds PARK_THRESHOLD is treated as parked by the packet path.
PARK_POS = 1.0e8
PARK_DIR = 0.5773502691896258  # 1/sqrt(3), per component
PARK_THRESHOLD = 1.0e7
