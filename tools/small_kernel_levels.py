"""Whether a process runs small kernels at a level of its own, with no code
of this repository on its path.

    torchrun --nproc_per_node=4 tools/small_kernel_levels.py --seconds 35 \\
        --out levels/round_0                      # one process a card
    torchrun --nproc_per_node=4 tools/small_kernel_levels.py --nccl ...

Imports only PyTorch (and Triton where it is installed).  Every process
takes the card of its ``LOCAL_RANK`` and captures four CUDA graphs, then
replays them one after another for ``--seconds`` seconds, each replay
between two CUDA events, the host synchronising every ``--batch``
iterations as a rollout's call does:

* ``torch_small``: 280 small PyTorch kernels on the shapes of the
  shared-map fleet's masks (1,024 lanes x 91 beams, a 500 x 500 uint8
  map): multiplies, adds, compares, ``index_put_`` into the map, ``where``;
* ``triton_small`` (where Triton builds): 280 launches of one small Triton
  kernel on the same (1,024, 91) tensor, kernels of the same size that are
  not PyTorch's;
* ``copy``: one 256 MiB device copy (bandwidth);
* ``mm``: one 2048 x 2048 float32 matrix product, TF32 off (compute).

With ``--nccl`` the processes join one NCCL group and MAX-all-reduce two
250,000-byte uint8 masks after every iteration (``nccl``), as the
shared-map fleet pools its masks every step.

Writes ``<out>/rank<r>.json`` (each batch's host time since the window's
start and its median ms of every graph) and prints, for each rank, the
per-second medians of ``torch_small`` and each graph's first-2-s and
last-5-s medians.  A level of the process shows as a first stretch of
seconds at one median and the rest at another, at different moments in
different processes, while the programs are the same.
"""

import argparse
import json
import os
import statistics
import tempfile
import time

import torch

B, NB, H, W = 1024, 91, 500, 500
REPEATS = 40  # 7 kernels a repeat: 280 a graph
_held = []  # the captured functions, so that their tensors outlive them


def torch_small(dev, gen):
    a = torch.rand(B, NB, device=dev, generator=gen)
    b = torch.rand(B, NB, device=dev, generator=gen)
    grid = torch.zeros(H * W, dtype=torch.uint8, device=dev)
    idx = torch.randint(0, H * W, (B * NB,), device=dev, generator=gen)
    out = torch.zeros(B, device=dev)

    def step():
        t = a
        for _ in range(REPEATS):
            t = t * b
            t = t + 0.5
            m = t > 1.0
            grid.index_put_((idx,), m.view(-1).to(torch.uint8))
            t = torch.where(m, t - 1.0, t)
            t = t.abs()
        out.copy_(t.sum(1))

    return step


def triton_small(dev, gen):
    import triton
    import triton.language as tl

    @triton.jit
    def axpb(x_ptr, y_ptr, n, BLOCK: tl.constexpr):
        i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        keep = i < n
        x = tl.load(x_ptr + i, mask=keep)
        tl.store(y_ptr + i, x * 0.999 + 0.5, mask=keep)

    x = torch.rand(B, NB, device=dev, generator=gen)
    y = torch.empty_like(x)
    n = x.numel()
    grid = (triton.cdiv(n, 1024),)

    def step():
        src, dst = x, y
        for _ in range(REPEATS * 7):
            axpb[grid](src, dst, n, BLOCK=1024)
            src, dst = dst, src

    return step


def big_copy(dev, gen):
    src = torch.rand(64 << 20, device=dev, generator=gen)
    dst = torch.empty_like(src)
    return lambda: dst.copy_(src)


def matmul(dev, gen):
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.rand(2048, 2048, device=dev, generator=gen)
    b = torch.rand(2048, 2048, device=dev, generator=gen)
    c = torch.empty_like(a)
    return lambda: torch.mm(a, b, out=c)


def capture(fn):
    """A CUDA graph of ``fn()``; it holds ``fn``, whose tensors the graph
    reads (the capture empties the allocator's cache, so a freed input's
    memory would be released to CUDA)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    _held.append(fn)
    return g


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=35.0)
    p.add_argument("--batch", type=int, default=50)
    p.add_argument("--nccl", action="store_true")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "small_kernel_levels"))
    args = p.parse_args()

    rank = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234 + rank)
    graphs = {"torch_small": capture(torch_small(dev, gen))}
    try:
        graphs["triton_small"] = capture(triton_small(dev, gen))
    except Exception as e:  # no Triton, or it does not build here
        print(f"rank {rank}: triton_small left out ({type(e).__name__}: {e})",
              flush=True)
    graphs["copy"] = capture(big_copy(dev, gen))
    graphs["mm"] = capture(matmul(dev, gen))
    names = list(graphs)
    masks = None
    if args.nccl:
        import torch.distributed as dist
        dist.init_process_group("nccl")
        masks = [torch.zeros(H * W, dtype=torch.uint8, device=dev)
                 for _ in range(2)]
        for m in masks:
            dist.all_reduce(m, op=dist.ReduceOp.MAX)
        dist.barrier()
        names.append("nccl")
    torch.cuda.synchronize()

    rows = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        ev = [[torch.cuda.Event(enable_timing=True)
               for _ in range(len(names) + 1)] for _ in range(args.batch)]
        for e in ev:
            e[0].record()
            for i, g in enumerate(graphs.values()):
                g.replay()
                e[i + 1].record()
            if masks is not None:
                for m in masks:
                    dist.all_reduce(m, op=dist.ReduceOp.MAX)
                e[-1].record()
        torch.cuda.synchronize()
        ms = [statistics.median(e[i].elapsed_time(e[i + 1]) for e in ev)
              for i in range(len(names))]
        rows.append([time.perf_counter() - t0] + ms)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "device": torch.cuda.get_device_name(dev),
                   "affinity": sorted(os.sched_getaffinity(0)),
                   "columns": ["t_s"] + names, "rows": rows}, f)

    def med(col, lo, hi):
        v = [r[col] for r in rows if lo <= r[0] < hi]
        return statistics.median(v) if v else float("nan")

    end = rows[-1][0]
    per_s = [med(1, s, s + 1) for s in range(int(end))]
    line = " ".join(f"{v:.3f}" for v in per_s)
    parts = ", ".join(f"{n} {med(i + 1, 0, 2):.4f} -> "
                      f"{med(i + 1, end - 5, end + 1):.4f}"
                      for i, n in enumerate(names))
    print(f"rank {rank}: {len(rows)} batches; first 2 s -> last 5 s: "
          f"{parts}\nrank {rank} torch_small ms by second: {line}",
          flush=True)
    if masks is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
