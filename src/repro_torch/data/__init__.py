from .pipeline import SyntheticLM, make_batch_specs  # noqa: F401
