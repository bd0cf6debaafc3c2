"""Launch layer of the port: the serving, training and elastic launchers, the
meshes, and the dry-run (specs, trace, graph analysis, roofline)."""
