"""AdamW over a model group: each rank keeps the moments of its share of a
net's parameters (``parallel/mesh.py``), as JAX's ``state_shardings`` places
the optimizer state of every leaf that ``_leaf_spec`` matches.

For a parameter the rule matches, the optimizer's leaf is this rank's dim-0
block of it: a view of the parameter's storage, so the update writes into
the parameter and the moments are 1/``model`` of its size. Every other
parameter is handed over whole, and every rank of the group updates it
alike. After each step one coalesced ``all_gather_into_tensor`` over the
model group writes every rank's blocks into every rank's parameters.

The state dict is the unsharded AdamW's, in the reference format (one entry
a parameter, in ``net.parameters()``' order, full-shaped moments):
``state_dict`` gathers the moment blocks over the model group, so every
rank of the group must call it together; ``load_state_dict`` takes a full
state and keeps this rank's blocks. A ``.pth`` pair then resumes at any
``(data, model)``, one process included.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import torch
import torch.distributed as dist

from smart_vocoder_torch.parallel.mesh import Mesh, leaf_sharded


def gather_blocks(blocks: Sequence[torch.Tensor], fulls: Sequence[torch.Tensor],
                  mesh: Mesh) -> None:
    """Write every rank's ``blocks`` into ``fulls`` (contiguous, each block
    this rank's dim-0 block of its full tensor) by one all-gather over the
    model group."""
    if not blocks:
        return
    flat = torch.cat([b.reshape(-1) for b in blocks])
    out = flat.new_empty(flat.numel() * mesh.model)
    dist.all_gather_into_tensor(out, flat, group=mesh.model_group)
    by_rank = out.view(mesh.model, -1)
    offset = 0
    for full, block in zip(fulls, blocks):
        n = block.numel()
        full.view(mesh.model, n).copy_(by_rank[:, offset:offset + n])
        offset += n


class ShardedAdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` over this rank's share of ``params`` in
    ``mesh``'s model group (see the module's docstring)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], mesh: Mesh, **kwargs):
        self.full: List[torch.nn.Parameter] = list(params)
        self.mesh = mesh
        self.sharded = [leaf_sharded(p.shape, mesh.model) for p in self.full]
        super().__init__([mesh.block(p.detach()) if s else p
                          for p, s in zip(self.full, self.sharded)], **kwargs)

    @property
    def leaves(self) -> List[torch.Tensor]:
        return self.param_groups[0]["params"]

    def take_gradients(self, grads: Sequence[torch.Tensor]) -> None:
        """Hand each leaf its gradient: the block of the full parameter's
        gradient where the leaf is a block, the whole gradient elsewhere."""
        if len(grads) != len(self.full):
            raise ValueError(f"{len(grads)} gradients for {len(self.full)} parameters")
        for leaf, g, s in zip(self.leaves, grads, self.sharded):
            leaf.grad = self.mesh.block(g) if s else g

    @torch.no_grad()
    def step(self, closure=None):
        """AdamW on the leaves, then every rank's blocks into the parameters."""
        loss = super().step(closure)
        pairs = [(leaf, p) for leaf, p, s in zip(self.leaves, self.full, self.sharded) if s]
        gather_blocks([leaf for leaf, _ in pairs], [p.detach() for _, p in pairs], self.mesh)
        return loss

    def state_dict(self):
        """The unsharded AdamW's state dict: each moment of a block gathered
        into a tensor of its parameter's shape (a collective of the model
        group: every rank of it must call this)."""
        out = super().state_dict()
        blocks, fulls = [], []
        for i, st in out["state"].items():
            if not self.sharded[i]:
                continue
            full_st = dict(st)
            for k, v in st.items():
                if torch.is_tensor(v) and v.shape == self.leaves[i].shape:
                    full_st[k] = v.new_empty(self.full[i].shape)
                    blocks.append(v)
                    fulls.append(full_st[k])
            out["state"][i] = full_st
        gather_blocks(blocks, fulls, self.mesh)
        return out

    def load_state_dict(self, state_dict) -> None:
        """Load an unsharded AdamW's state dict (a ``.pth`` pair's, from any
        mesh), keeping this rank's block of each sharded moment."""
        state = {}
        for i, st in state_dict["state"].items():
            if self.sharded[i]:
                shape = self.full[i].shape
                bad = [k for k, v in st.items() if torch.is_tensor(v) and v.ndim
                       and v.shape != shape]
                if bad:
                    raise ValueError(f"optimizer state {i}: {bad} are not of the parameter's "
                                     f"shape {tuple(shape)}")
                st = {k: self.mesh.block(v).clone() if torch.is_tensor(v) and v.ndim else v
                      for k, v in st.items()}
            state[i] = st
        super().load_state_dict({**state_dict, "state": state})
