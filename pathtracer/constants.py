"""Numerical conventions shared by the CPU oracle and the JAX tracer.

These constants ARE the semantics contract: oracle/tracer.py (numpy) and
engine/wavefront.py (JAX) must use literally these values so that renders
match allclose at fixed seeds (SURVEY.md §0.3). Change them only in lockstep
with regenerated goldens.
"""

# Ray t-interval. t >= T_FAR means "miss".
T_MIN = 1e-4
T_FAR = 1e8

# Möller–Trumbore determinant cutoff (parallel-ray guard).
DET_EPS = 1e-9

# Secondary/shadow ray origins are offset this far along the shading normal
# to avoid self-intersection acne (scene scale is the unit Cornell box).
RAY_OFFSET = 1e-3

# A shadow ray is unoccluded iff its closest hit lies at
# t >= dist_to_light * (1 - SHADOW_REL_EPS); the light triangle itself is
# always hit at t ~= dist (distance recomputed from the offset origin).
SHADOW_REL_EPS = 1e-3

# Russian roulette continuation probability clamp.
RR_CLAMP_LO = 0.05
RR_CLAMP_HI = 0.95

# Material types (smallpt-style DIFF/SPEC/REFR set — the material palette
# of the reference's class of CUDA Cornell tracers; SURVEY.md §2.1 R4).
# Stored per material id in Geometry.mat_type: the type table is scene
# structure, NOT a differentiable parameter (SURVEY.md §7 hard part 3).
MAT_DIFF = 0  # Lambertian: cosine-sampled, NEE applies
MAT_SPEC = 1  # perfect mirror: delta reflection, tinted by albedo
MAT_REFR = 2  # smooth dielectric: Fresnel reflect/refract (Geometry.mat_ior)
