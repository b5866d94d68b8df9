"""Command-line entry points of the port (``python -m
deepcharuco_tpu_torch.cli.train``, ``...cli.train_refinenet``)."""


def not_ported(what: str, item: str = "A10"):
    """Raise for a flag whose machinery the port does not have yet."""
    raise NotImplementedError(f"{what} is not ported to deepcharuco_tpu_torch yet "
                              f"(ROADMAP.md §A, {item})")
