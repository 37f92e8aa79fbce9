"""Motion-estimation solvers of the per-frame path (the port of plo_tpu/solvers:
build, ls, drpm, ransac, gauss_newton). Each consumes a masked correspondence set
(source, ref, ref_normal, valid) and returns a 4x4 delta transform."""
