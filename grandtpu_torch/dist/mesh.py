"""The port's device mesh (port of ``grandtpu/dist/mesh.py``).

grandtpu runs its row-partitioned propagation as one process over a JAX
mesh of local devices (``shard_map``). The port keeps that model: a
:class:`Mesh` is an ordered list of ``torch.device``s on the data axis, one
shard each, driven by one process; its collectives are methods over
per-shard tensor lists, built from ``Tensor.to`` copies (peer copies
between cards) and ``torch.cat``/``torch.stack``. A device may stand in the
list more than once: several shards then share one card (or the CPU), as
``chip_smoke.py`` runs four shards on one card and the tests run them on
the CPU. Meshes that span processes (``torch.distributed``/NCCL) come with
data-parallel training (ROADMAP Queue A 8).
"""

from __future__ import annotations

import dataclasses

import torch

from grandtpu_torch.device import resolve_device

_TP = "ROADMAP Queue A 8: data-parallel and tensor-parallel training (D2)"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shards on the data axis, in order: ``devices[s]`` holds shard s."""
    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "model": 1}

    @property
    def size(self) -> int:
        return len(self.devices)

    def _per_device(self, make):
        """``make(device)`` once for each distinct device, in shard order."""
        made = {}
        for d in self.devices:
            if d not in made:
                made[d] = make(d)
        return [made[d] for d in self.devices]

    def all_gather(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each shard's [r, ...] block, concatenated in shard order on every
        shard's device ([S * r, ...]); shards on one device share the copy,
        which they must only read."""
        return self._per_device(
            lambda d: torch.cat([x.to(d) for x in xs]))

    def all_to_all(self, sends: list[torch.Tensor]) -> list[torch.Tensor]:
        """``sends[s]`` [S, C, ...] holds what shard s sends to each shard;
        shard d receives ``stack_s(sends[s][d])`` [S, C, ...] on its
        device (grandtpu's ``lax.all_to_all`` with split and concat axis
        0, untiled)."""
        return [torch.stack([send[d].to(dev) for send in sends])
                for d, dev in enumerate(self.devices)]

    def pmax(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """The elementwise max of every shard's tensor, on every shard's
        device."""
        def make(d):
            out = xs[0].to(d, copy=True)
            for x in xs[1:]:
                torch.maximum(out, x.to(d), out=out)
            return out

        return self._per_device(make)

    def gather_rows(self, xs: list[torch.Tensor]) -> torch.Tensor:
        """The shards' row blocks concatenated on the first device."""
        return torch.cat([x.to(self.devices[0]) for x in xs])


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None,
              device="cuda") -> Mesh:
    """A mesh of ``n_data`` shards on the data axis. ``devices``: the
    devices in shard order (repeats allowed); by default the first
    ``n_data`` visible cards, or ``n_data`` times the CPU when ``device``
    is "cpu". Raises when there are fewer cards than ``n_data`` (no quiet
    fall-back to sharing one). ``n_model > 1`` (tensor parallel) is not
    ported."""
    if n_model != 1:
        raise NotImplementedError(f"n_model > 1 is not ported yet ({_TP})")
    if devices is None:
        device = resolve_device(device)
        if device.type == "cpu":
            devices = [device] * (n_data or 1)
        else:
            count = torch.cuda.device_count()
            n = count if n_data is None else n_data
            if n > count:
                raise ValueError(f"need {n} CUDA devices, have {count}; "
                                 "list the devices to share one")
            devices = [torch.device("cuda", i) for i in range(n)]
    devices = [resolve_device(d) for d in devices]
    if n_data is None:
        n_data = len(devices)
    if not 0 < n_data <= len(devices):
        raise ValueError(f"need {n_data} devices, have {len(devices)}")
    # "cuda" and "cuda:0" are one card: name each by its index
    return Mesh(tuple(
        torch.device("cuda", torch.cuda.current_device())
        if d.type == "cuda" and d.index is None else d
        for d in devices[:n_data]))
