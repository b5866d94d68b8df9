"""Configuration schema and loader (the port's own copy).

Same YAML keys and the same derived ``n_ids = (row_count-1)*(col_count-1)``
as ``deepcharuco_tpu.configs``, so one config file serves both packages.
``yaml`` is imported only inside :func:`load_configuration`: the port runs
where PyYAML is absent as long as no YAML file is read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    """Board + training configuration (reference-compatible schema)."""

    board_name: str
    row_count: int
    col_count: int
    square_len: float
    marker_len: float

    input_size: Tuple[int, int]  # (W, H) — reference convention
    num_workers: int = 6
    bs_train: int = 32
    bs_train_rn: int = 64
    bs_val: int = 64
    bs_val_rn: int = 128
    train_labels: str = ""
    val_labels: str = ""
    train_images: str = ""
    val_images: str = ""

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    data_axis: int = 8

    n_ids: Optional[int] = None

    def __post_init__(self):
        if self.n_ids is None:
            object.__setattr__(
                self, "n_ids", (self.row_count - 1) * (self.col_count - 1)
            )
        if not isinstance(self.input_size, tuple):
            object.__setattr__(self, "input_size", tuple(self.input_size))

    @property
    def input_wh(self) -> Tuple[int, int]:
        """(width, height) — the on-disk YAML convention."""
        return self.input_size

    @property
    def input_hw(self) -> Tuple[int, int]:
        """(height, width) — the tensor-shape convention."""
        return (self.input_size[1], self.input_size[0])


def load_configuration(path: str) -> Config:
    """Load a YAML config (same file format as the JAX package)."""
    import yaml

    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    known = {f.name for f in dataclasses.fields(Config)}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(f"Unknown config keys: {sorted(unknown)}")
    return Config(**raw)


def default_config(**overrides) -> Config:
    """The demo configuration (5×5 DICT_4X4_50 board, 320×240 input)."""
    base = dict(
        board_name="DICT_4X4_50",
        row_count=5,
        col_count=5,
        square_len=0.01,
        marker_len=0.0075,
        input_size=(320, 240),
    )
    base.update(overrides)
    return Config(**base)


def scaled_config(cfg: Config, factor: int = 2) -> Config:
    """The same board and config with ``input_size`` scaled ``factor``×: the
    hi-res frame view that ``--frame-scale`` synthesises at (the board's
    geometry is physical and unchanged; its render gains detail)."""
    return dataclasses.replace(cfg, input_size=(cfg.input_size[0] * factor,
                                                cfg.input_size[1] * factor))
