"""Hand-written device kernels: intersect_gpu (ray x triangle nearest hit)
and quadric (exact analytic-surface intersection)."""
