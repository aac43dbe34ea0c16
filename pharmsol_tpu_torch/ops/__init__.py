from .export import export_function, export_psi, load_exported  # noqa: F401
