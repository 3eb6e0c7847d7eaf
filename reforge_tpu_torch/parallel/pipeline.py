"""Pipeline stages: graph layers staged across devices (the port of
``reforge_tpu/parallel/pipeline.py``).

Topological layers are partitioned into S cost-balanced stages, one device
a stage, and the values a later stage reads move to its device
(``Tensor.to``).  Launches are asynchronous, so a host loop that keeps
several frames in flight (``render_stream``) fills the pipeline: device s
works on frame i while device s - 1 works on frame i + 1.  Each stage runs
its nodes per node, as the reference's stages do.

Worth it for long chains of similarly heavy nodes; for short graphs the
stage-boundary copies dominate and single-device fusion wins.  The engine
does not default to it; it is a library strategy and the CLI's
``--pipeline S``.
"""

from __future__ import annotations

import sys
from collections import deque
from typing import Any, Optional, Sequence

import torch

from ..config import FILE_INPUT, FINAL_OUTPUT
from ..graph.builder import PipelineNode
from ..graph.program import GraphProgram
from .mesh import available_devices


def _node_cost(node: PipelineNode) -> float:
    """Fallback per-node cost when no measured costs are given: pointwise
    1, a conv growing with its radius."""
    halo = node.halo
    if halo is None:
        return 4.0  # gather-ish
    return 1.0 + 0.2 * halo


def measure_costs(
    program: GraphProgram,
    file_input: Optional[torch.Tensor] = None,
    t: float = 0.0,
    reps: int = 3,
) -> dict[str, float]:
    """Measured per-node costs (ms) for stage balancing: the program's
    per-node timed execution (``run_per_node``, as ``--timing per-node``)
    ``reps`` times after a warmup, the least time of each node."""
    if file_input is None:
        file_input = torch.zeros((4, program.height, program.width), dtype=torch.float32,
                                 device=program.device)
    program.run_per_node(file_input, t)  # warm up
    best: dict[str, float] = {}
    for i in range(max(reps, 1)):
        _, times = program.run_per_node(file_input, t + 0.01 * i)
        for name, ms in times.items():
            if name not in best or ms < best[name]:
                best[name] = ms
    return best


def split_layers(
    layers: Sequence[Sequence[PipelineNode]],
    n_stages: int,
    node_costs: Optional[dict[str, float]] = None,
) -> list[list[list[PipelineNode]]]:
    """Partition consecutive layers into n_stages cost-balanced groups.

    ``node_costs`` maps node name -> measured ms (see measure_costs);
    nodes missing from it, or a None map, use the static heuristic."""

    def cost_of(n: PipelineNode) -> float:
        if node_costs is not None and n.name in node_costs:
            return node_costs[n.name]
        return _node_cost(n)

    costs = [sum(cost_of(n) for n in layer) for layer in layers]
    total = sum(costs) or 1.0
    target = total / n_stages
    stages: list[list] = []
    current: list = []
    acc = 0.0
    remaining_stages = n_stages
    for i, (layer, cost) in enumerate(zip(layers, costs)):
        layers_left = len(layers) - i
        if (
            current
            and acc + cost > target * 1.25
            and remaining_stages > 1
            and layers_left >= remaining_stages - 1
        ):
            stages.append(current)
            current = []
            acc = 0.0
            remaining_stages -= 1
        current.append(layer)
        acc += cost
    if current:
        stages.append(current)
    while len(stages) < n_stages and len(stages) > 0 and len(stages[-1]) > 1:
        # Split the last group if we came up short on stages.
        last = stages.pop()
        stages.append(last[:-1])
        stages.append(last[-1:])
    return stages


class PipelineStagedProgram:
    """A graph program run as stages on devices, one device a stage."""

    def __init__(self, program: GraphProgram, devices: Optional[list] = None,
                 n_stages: Optional[int] = None,
                 node_costs: Optional[dict[str, float]] = None,
                 measure: bool = False):
        """``devices``: the stages' devices (default: every device of the
        program's kind; a list may repeat one); ``node_costs``: measured
        per-node ms for stage balancing (see measure_costs);
        ``measure=True`` measures them here (the per-node program, a few
        frames)."""
        self.program = program
        devs = [torch.device(d) for d in
                (devices if devices is not None else available_devices(program.device.type))]
        if measure and node_costs is None:
            node_costs = measure_costs(program)
        self.node_costs = node_costs
        n = n_stages or len(devs)
        n = max(1, min(n, len(devs), len(program.graph.layers)))
        self.stage_layers = split_layers(program.graph.layers, n, node_costs)
        # The splitter may give fewer groups than asked (one heavy trailing
        # layer); follow the actual count.
        n = len(self.stage_layers)
        self.devices = devs[:n]
        print(f"pipeline: {n} stage(s) of {len(program.graph.layers)} layer(s) on "
              f"{', '.join(map(str, self.devices))} ({n_stages or len(devs)} asked)",
              file=sys.stderr)

        # Cross-stage interface: which resources each stage reads from
        # earlier stages, and which it hands to later ones.
        produced_by_stage: list[set] = []
        self._stage_inputs: list[list[str]] = []
        self._stage_outputs: list[list[str]] = []
        for group in self.stage_layers:
            nodes = [node for layer in group for node in layer]
            consumed = {res for node in nodes for res, _ in node.inputs}
            produced = {res for node in nodes for res, _ in node.outputs}
            self._stage_inputs.append(sorted(consumed - produced))
            produced_by_stage.append(produced)
        for s in range(n):
            later_needs = set()
            for s2 in range(s + 1, n):
                later_needs.update(self._stage_inputs[s2])
            exports = produced_by_stage[s] & later_needs
            if FINAL_OUTPUT in produced_by_stage[s]:
                exports.add(FINAL_OUTPUT)
            self._stage_outputs.append(sorted(exports))

    def _run_stage(self, s: int, inputs: dict, t: float) -> dict:
        prog, dev = self.program, self.devices[s]
        ctx = prog._ctx(t, dev)
        resources = dict(inputs)
        if FILE_INPUT in resources:
            # The storage cast of GraphProgram._forward.
            resources[FILE_INPUT] = resources[FILE_INPUT].to(prog.storage_dtype)
        for layer in self.stage_layers[s]:
            for node in layer:
                resources.update(prog._run_node(node, ctx, resources))
        return {name: resources[name] for name in self._stage_outputs[s]}

    def shard_input(self, file_input: torch.Tensor) -> torch.Tensor:
        """Engine-interface parity with the sharded programs: each stage
        moves its inputs in ``__call__``."""
        return file_input

    def compile(self) -> None:
        """Nothing to build ahead: each stage runs the program's per-node
        kernels, built once a process (callable from a build thread)."""

    def __call__(self, file_input: torch.Tensor, t) -> torch.Tensor:
        t = float(t)
        live: dict[str, Any] = {FILE_INPUT: file_input}
        for s, dev in enumerate(self.devices):
            inputs = {name: live[name].to(dev, non_blocking=True)
                      for name in self._stage_inputs[s]}
            if s == 0 and FILE_INPUT not in inputs:
                inputs[FILE_INPUT] = file_input.to(dev, non_blocking=True)
            live.update(self._run_stage(s, inputs, t))
        return live[FINAL_OUTPUT]

    def render_stream(self, frames, times=None, depth: Optional[int] = None):
        """Several frames in flight: yields the outputs in order.

        ``frames`` is an iterable of (4, H, W) inputs; ``times`` an optional
        parallel sequence of frame times (default: the frame index / 60).
        Every stage's launches are asynchronous, so frame i + 1 is issued
        while stage s still works on frame i.  At most ``depth`` frames
        (default: the stage count + 1) are in flight; the oldest is waited
        on (its CUDA event) before the next is admitted, bounding device
        memory as the engine's in-flight queue does."""
        if depth is None:
            depth = len(self.devices) + 1
        depth = max(depth, 1)
        pending: deque = deque()

        def wait(item):
            out, done = item
            if done is not None:
                done.synchronize()
            return out

        for i, frame in enumerate(frames):
            t = (i / 60.0) if times is None else times[i]
            if len(pending) >= depth:
                yield wait(pending.popleft())
            out = self(frame, t)
            done = None
            if out.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(out.device))
            pending.append((out, done))
        while pending:
            yield wait(pending.popleft())
