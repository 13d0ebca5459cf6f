"""Synthetic data of the port (``pipeline``): the Markov token stream the
training runs learn and the teacher-labelled classification set."""

from repro_torch.data.pipeline import (
    SyntheticLM,
    TeacherDataset,
    batch_iterator,
)

__all__ = ["SyntheticLM", "TeacherDataset", "batch_iterator"]
