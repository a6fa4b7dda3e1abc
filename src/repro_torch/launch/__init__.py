"""The production dry run: meshes, the H100 roofline, depth extrapolation,
preflight, sweep and summary."""
