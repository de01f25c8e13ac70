"""On-device uniform replay buffer (port of ambersim_tpu/rl/sac/replay.py).

A fixed-capacity ring buffer of preallocated device tensors: `insert`
writes a batch in place at (insert_position + arange(n)) % capacity,
`sample` gathers a batch of rows. The write position and the fill level
are Python ints on the host: both follow from the batch sizes alone, so
sampling draws its indices with no device-to-host read. At MLP-RL sizes
(1M transitions x ~100 floats) the buffer is a few hundred MB of device
memory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ambersim_tpu_torch.rl.sac.losses import Transition


@dataclasses.dataclass
class ReplayBufferState:
    data: Transition  # every field with a leading axis of `capacity` rows
    insert_position: int = 0  # next write slot
    size: int = 0  # number of valid rows

    @property
    def capacity(self) -> int:
        return self.data.reward.shape[0]


def init(capacity: int, dummy_item: Transition, device=None) -> ReplayBufferState:
    """A buffer of `capacity` zero rows shaped like `dummy_item` (one
    transition, no leading batch axis), on `device` (dummy_item's by
    default)."""
    return ReplayBufferState(data=dummy_item.map(
        lambda x: torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype, device=x.device if device is None else device)
    ))


def insert(state: ReplayBufferState, batch: Transition) -> ReplayBufferState:
    """Write `batch` (leading axis of n rows) over the oldest rows, in place;
    returns the state with the advanced position and size. A batch larger
    than the capacity is refused: its indices would wrap onto each other."""
    capacity, n = state.capacity, batch.reward.shape[0]
    if n > capacity:
        raise ValueError(f"replay.insert: batch of {n} exceeds buffer capacity {capacity}")
    idx = (state.insert_position + torch.arange(n, device=state.data.reward.device)) % capacity
    for f in dataclasses.fields(Transition):
        getattr(state.data, f.name)[idx] = getattr(batch, f.name)
    return dataclasses.replace(state, insert_position=(state.insert_position + n) % capacity,
                               size=min(state.size + n, capacity))


def sample(state: ReplayBufferState, seed: Union[torch.Generator, torch.Tensor],
           batch_size: Optional[int] = None) -> Transition:
    """`batch_size` rows drawn uniformly with replacement from the valid
    ones, with indices from the generator `seed`; or the rows at the
    indices `seed` itself (a test replays the JAX package's draws so)."""
    if isinstance(seed, torch.Tensor):
        idx = seed.to(state.data.reward.device)
    else:
        idx = torch.randint(0, max(state.size, 1), (batch_size,), generator=seed, device=seed.device)
        idx = idx.to(state.data.reward.device)
    return state.data.map(lambda buf: buf[idx])
