"""Active learning: greedy sensor placement with an uncertainty acquisition."""

from deepsensornz_tpu_torch.al.greedy import GreedyAlgorithm, Stddev  # noqa: F401
