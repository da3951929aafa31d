"""Utilities: diagnostics, validation, profiling, checkpointing, logging."""

from mh_tpu_torch.utils.checkpoint import (
    restore_local_shards, restore_state, save_local_shards, save_state,
)
from mh_tpu_torch.utils.metrics import effective_sample_size, split_r_hat, summarize_chains
from mh_tpu_torch.utils.profiling import PhaseTimer, force_completion, trace
from mh_tpu_torch.utils.validation import check_state_finite, require_valid, validate_spec
