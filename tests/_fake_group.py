"""A fake process group for the port's mesh tests: `fake_world(n)` makes
this process rank 0 of `n` ranks (`torch.distributed`'s "fake" backend,
whose collectives do nothing), so a 16x16 or 2x16x16 `DeviceMesh` and its
DTensor placements exist on one CPU.  A process holds one default group at
a time, and `--dist loadfile` runs several test files in one worker
process: the group is destroyed on exit, and entering fails if another
test left one initialised."""

import contextlib

import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore


@contextlib.contextmanager
def fake_world(n: int):
    assert not dist.is_initialized(), \
        "a process group was left initialised by an earlier test"
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
