"""Inter-operator pipeline executor — the paper's pipeline parallelism
(Fig. 1c) with one CUDA stream per stage group, on one card or over the
slots of a mesh.

A DYPE schedule assigns kernel groups to device pools. Each stage group
gets its own CUDA stream; a ``torch.cuda.Event`` recorded after a stage's
work and waited on by the next stage's stream hands the activation over
(the counterpart of the reference's ``ppermute``). Microbatches stream
GPipe-style with the reference's round structure:

  * ``m + s - 1`` rounds for m microbatches and s stages;
  * in round r stage 0 injects ``micro[min(r, m-1)]``, every other stage
    takes what the previous stage group's head produced in round r-1;
  * the last head emits microbatch ``r - (s-1)``;
  * activations keep one ``(B, F)`` shape across stage boundaries.

Where the reference computes a stage on a pipeline bubble (stage s before
round s, or after its last microbatch) and discards the result, this
executor skips the work: the outputs are the same, and each stage runs
exactly once per microbatch.

Without a mesh every stage runs on one device and the handover passes the
activation itself. With a ``launch.mesh.Mesh`` and one of its axes, stage
s runs on its group head's slot of that axis: its parameters live on that
device, its stream is one of that device's, and the handover copies the
activation onto the next head's device (a peer copy between two cards, a
same-card copy when two slots name one device), ordered after the
producer's event. Outputs are collected on the last head's device. On the
CPU the same rounds run in order, and a mesh of CPU slots copies at each
handover.

Tensors cross streams: an activation made on stage s's stream is read on
stage s+1's, so it is ``record_stream``-ed there, or the caching allocator
could hand its memory out again before the reader is done. The call makes
every stage stream wait for the caller's stream first and makes the
caller's stream, and each stage device's current stream, wait for every
stage stream before returning.
"""
from __future__ import annotations

import torch

from ..device import resolve_device


def pipeline_round_count(n_micro: int, n_stages: int) -> int:
    return n_micro + n_stages - 1


class PipelineExecutor:
    """Runs a chain of ``stage_fns`` (one per pipeline stage).
    stage_fns[i]: (params_i, x) -> y, all x/y of shape ``act_shape``.

    stacked_params maps names to tensors stacked along a leading stage
    dim; stage i sees only its own slice ``{k: v[i]}`` (the paper's
    pre-loaded static data, §II-B), on its own device.

    ``mesh``/``axis``: place stage i on slot i of the mesh's ``axis`` (which
    must have one slot per stage); microbatches enter on stage 0's device.
    Without a mesh every stage runs on ``device``."""

    def __init__(self, stage_fns, stacked_params, act_shape, *,
                 act_dtype=torch.float32, device=None, mesh=None,
                 axis: str = "stage"):
        self.stage_fns = list(stage_fns)
        self.n_stages = len(self.stage_fns)
        self.mesh, self.axis = mesh, axis
        if mesh is None:
            self.device = resolve_device(device)
            self.stage_devices = (self.device,) * self.n_stages
        else:
            # GroupedPipelineExecutor sets heads and n_devices first
            heads = getattr(self, "heads", tuple(range(self.n_stages)))
            n_slots = getattr(self, "n_devices", self.n_stages)
            slots = mesh.slots(axis)
            if len(slots) != n_slots:
                raise ValueError(f"mesh axis {axis!r} has {len(slots)} "
                                 f"slots, the pipeline takes {n_slots}")
            self.stage_devices = tuple(slots[h] for h in heads)
            self.device = self.stage_devices[0]
        self.local = [{k: v[s].to(self.stage_devices[s])
                       for k, v in stacked_params.items()}
                      for s in range(self.n_stages)]
        self.act_shape = tuple(act_shape)
        self.act_dtype = act_dtype
        self.streams = ([torch.cuda.Stream(d) for d in self.stage_devices]
                        if self.device.type == "cuda" else None)

    def __call__(self, microbatches: torch.Tensor) -> torch.Tensor:
        """microbatches: (n_micro, B, F) on stage 0's device. Returns
        (n_micro, B, F) outputs, collected on the last head's device."""
        if tuple(microbatches.shape[1:]) != self.act_shape \
                or microbatches.dtype != self.act_dtype:
            raise ValueError(f"want (m, {self.act_shape}) {self.act_dtype}, "
                             f"got {tuple(microbatches.shape)} "
                             f"{microbatches.dtype}")
        if microbatches.device != self.device:
            raise ValueError(f"microbatches on {microbatches.device}, "
                             f"stage 0 on {self.device}")
        if self.streams is None:
            return self._run(microbatches, None)
        return self._run_streams(microbatches)

    def _run(self, micro, streams):
        """The GPipe rounds. With ``streams``, stage s's work is enqueued on
        streams[s] and handed over by events; without, it runs in order."""
        m, s = micro.shape[0], self.n_stages
        outs = torch.empty_like(micro, device=self.stage_devices[-1])
        handed = [None] * s                # (activation, event) per stage
        for r in range(pipeline_round_count(m, s)):
            nxt = [None] * s
            for st in range(max(0, r - m + 1), min(s, r + 1)):
                if streams is None:
                    x = (micro[min(r, m - 1)] if st == 0
                         else self._handover(handed[st - 1][0], st))
                    y = self.stage_fns[st](self.local[st], x)
                    nxt[st] = (y, None)
                else:
                    nxt[st] = self._stage_on_stream(streams, st, r, micro,
                                                    handed)
                if st == s - 1:
                    self._emit(streams, outs, r - (s - 1), nxt[st][0])
            handed = nxt
        return outs

    def _handover(self, y, st):
        """Stage st's input from stage st-1's output ``y``, in order (no
        streams): the tensor itself on one device, a copy on a mesh."""
        if self.mesh is None:
            return y
        return y.to(self.stage_devices[st], copy=True)

    def _stage_on_stream(self, streams, st, r, micro, handed):
        stream = streams[st]
        with torch.cuda.stream(stream):
            if st == 0:
                x = micro[min(r, micro.shape[0] - 1)]
            else:
                x = self._take(streams, st, *handed[st - 1])
            y = self.stage_fns[st](self.local[st], x)
            ev = torch.cuda.Event()
            ev.record(stream)
        return y, ev

    def _take(self, streams, st, y, ev):
        """Stage st's input on its stream: wait for the producer's event,
        then read ``y`` in place, or copy it onto stage st's device on a
        mesh. A copy between two cards is enqueued, as PyTorch does, on
        the source card's current stream, set here to the producer's
        (already ordered after ``y``); PyTorch makes ``streams[st]`` wait
        for it."""
        stream = streams[st]
        stream.wait_event(ev)
        if y.device == self.stage_devices[st]:
            y.record_stream(stream)        # read on this stream
        if self.mesh is None:
            return y
        with torch.cuda.stream(streams[st - 1]), torch.cuda.stream(stream):
            return y.to(self.stage_devices[st], copy=True)

    @staticmethod
    def _emit(streams, outs, j, y):
        if streams is None:
            outs[j] = y
            return
        with torch.cuda.stream(streams[-1]):
            outs[j].copy_(y)

    def _run_streams(self, micro):
        caller = torch.cuda.current_stream(self.device)
        for st in self.streams:
            st.wait_stream(caller)
        micro.record_stream(self.streams[0])
        outs = self._run(micro, self.streams)
        outs.record_stream(self.streams[-1])
        for st in self.streams:
            caller.wait_stream(st)
            if st.device != caller.device:
                torch.cuda.current_stream(st.device).wait_stream(st)
        return outs


class GroupedPipelineExecutor(PipelineExecutor):
    """Pipeline execution over DP-sized stage groups.

    The schedule's stages are laid out as contiguous groups of
    ``group_sizes[s]`` slots; the group head executes the stage and hands
    its activation to the next group's head (handover only at group
    heads). The other group members are the capacity the DP reserved for
    intra-stage operator parallelism, modelled in f_perf (§II-B) rather
    than materialised. Without a mesh every group is one stream of one
    device, so the grouping changes the bookkeeping (``heads``) and not
    the arithmetic; with a mesh, ``mesh.slots(axis)`` must hold
    ``sum(group_sizes)`` slots and stage s runs on slot ``heads[s]``."""

    def __init__(self, stage_fns, stacked_params, act_shape, group_sizes, *,
                 act_dtype=torch.float32, device=None, mesh=None,
                 axis: str = "stage"):
        self.group_sizes = tuple(int(n) for n in group_sizes)
        if len(self.group_sizes) != len(stage_fns) \
                or min(self.group_sizes, default=1) < 1:
            raise ValueError(f"group_sizes {self.group_sizes} for "
                             f"{len(stage_fns)} stages")
        self.n_devices = sum(self.group_sizes)
        heads, off = [], 0
        for n in self.group_sizes:
            heads.append(off)
            off += n
        self.heads = tuple(heads)
        super().__init__(stage_fns, stacked_params, act_shape,
                         act_dtype=act_dtype, device=device, mesh=mesh,
                         axis=axis)
