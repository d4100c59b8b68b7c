from . import cones, lanczos, linop, precision, tri  # noqa: F401
