"""Where the time of K8's conv kernel goes, on the card: builds a copy of
``csrc/conv_int8.cu`` into ``build/k8_stamps/`` in which one consumer thread
of each block stamps ``clock64()`` at the start of each tile, after its first
weight stage, at the end of its mainloop and of its epilogue, and sums the
cycles it waited on the halo and on the weight stages; then times that copy
at the widest int8 convs of the published model and prints, per tile, the
mainloop, the epilogue and the waits beside the tensor cores' ideal
(512 clocks a tap and 64-channel chunk: two k32 steps of m64n256 for each of
the two consumer warpgroups at 4,096 int8 products a clock)::

    python -m multimodal_registration_torch.tools.k8_stamps [--stages N] [--cluster N]

``--stages`` and ``--cluster`` build the copy with another number of weight
stages or blocks a cluster, to compare designs in one process. Needs a CUDA
card and ``nvcc``; the outputs are checked against the kernel's own.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from multimodal_registration_torch import kernels
from multimodal_registration_torch.ops import conv_int8 as ci

SHAPES = (("enc_1, final_0, final_1", 256, (80, 80, 96)), ("dec_3", 512, (80, 80, 96)))
MAX_TILES = 40  # stamped tiles a block
SLOTS = 200  # per block: 1 + 4 a tile, then the sums at 190-193

# (text of the source, text put in its place); each must occur once
STAMPS = (
    ("namespace {\n", f"__device__ long long g_stamps[264][{SLOTS}];\nnamespace {{\n"),
    ("const int tid = threadIdx.x, wg = tid >> 7;",
     "const int tid = threadIdx.x, wg = tid >> 7;\n"
     "  long long* st = g_stamps[blockIdx.x % 264];\n"
     "  if (tid == 128) st[0] = clock64();\n"
     "  long long waited_a = 0, waited_w = 0;"),
    ("    for (int i = 0; i < my_tiles; ++i) {\n",
     "    for (int i = 0; i < my_tiles; ++i) {\n"
     f"      if (tid == 128 && i < {MAX_TILES}) st[1 + 4 * i] = clock64();\n"),
    ("        mbar_wait(full_a(q & 1), (q >> 1) & 1);",
     "        { const long long t0 = clock64(); mbar_wait(full_a(q & 1), (q >> 1) & 1);"
     " waited_a += clock64() - t0; }"),
    ("          mbar_wait(full_w(s), (w_it / W_STAGES) & 1);",
     "          { const long long t0 = clock64(); mbar_wait(full_w(s), (w_it / W_STAGES) & 1);"
     " waited_w += clock64() - t0; }\n"
     f"          if (tid == 128 && i < {MAX_TILES} && c == 0 && tap == 1) st[2 + 4 * i] = clock64();"),
    ("      wgmma_wait<0>();\n      fence_sums(acc);\n      release_w",
     "      wgmma_wait<0>();\n"
     f"      if (tid == 128 && i < {MAX_TILES}) st[3 + 4 * i] = clock64();\n"
     "      fence_sums(acc);\n      release_w"),
    ("      warpgroup_sync(wg);  // and read: the next tile may write it again",
     "      warpgroup_sync(wg);  // and read: the next tile may write it again\n"
     f"      if (tid == 128 && i < {MAX_TILES}) st[4 + 4 * i] = clock64();"),
    ("  // no block leaves while its peer",
     "  if (tid == 128) { st[190] = waited_a; st[191] = waited_w; st[192] = my_tiles;"
     " st[193] = clock64(); }\n  // no block leaves while its peer"),
)


def build(stages: int | None, cluster: int | None) -> ctypes.CDLL:
    src = (kernels.CSRC / "conv_int8.cu").read_text()
    edits = list(STAMPS)
    if stages is not None:
        edits.append(("constexpr int W_STAGES = 4;", f"constexpr int W_STAGES = {stages};"))
    if cluster is not None:
        edits.append(("constexpr int CLUSTER = 2;", f"constexpr int CLUSTER = {cluster};"))
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"csrc/conv_int8.cu changed: {old!r} does not occur once")
        src = src.replace(old, new)
    src += ('\nextern "C" int stamps_read(void* dst) {\n'
            "  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));\n}\n")
    out = kernels.BUILD_DIR.parent / "k8_stamps"
    out.mkdir(parents=True, exist_ok=True)
    tag = f"s{stages or 'x'}_c{cluster or 'x'}"
    cu, so = out / f"conv_int8_{tag}.cu", out / f"conv_int8_{tag}.so"
    cu.write_text(src)
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(r.stdout + r.stderr)
    lib = ctypes.CDLL(str(so))
    lib.conv3_int8_launch.argtypes = kernels.CONV3_INT8._argtypes["conv3_int8_launch"]
    lib.stamps_read.argtypes = [ctypes.c_void_p]
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", type=int, default=None, help="weight stages (the source's: 4)")
    ap.add_argument("--cluster", type=int, default=None, help="blocks a cluster (the source's: 2)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    lib = build(args.stages, args.cluster)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, cin, grid in SHAPES:
        x = torch.randn((1, *grid, cin), device=dev, generator=gen).bfloat16()
        w = torch.randn((256, cin, 3, 3, 3), device=dev, generator=gen) * 0.02
        b = torch.randn((256,), device=dev, generator=gen) * 0.1
        with torch.inference_mode():
            want = ci.conv3_int8(x, w, b, 3.0)
            wk, scale, bias = ci.prepared_int8_weights(w, b, 3.0)
            xq = torch.nn.functional.pad(ci.quantize_act(x, 3.0), (0, -cin % 64))
        default = ci.CLUSTER
        ci.CLUSTER = args.cluster or default
        try:
            plan = ci.Int8ConvPlan(x.shape, 256)
        finally:
            ci.CLUSTER = default
        out = torch.empty_like(want)

        def call():
            rc = lib.conv3_int8_launch(xq.data_ptr(), wk.data_ptr(), scale.data_ptr(),
                                       bias.data_ptr(), out.data_ptr(), 1, *grid,
                                       *plan.launch_args(), 1, 0.2, kernels.stream_of(x))
            if rc != 0:
                raise SystemExit(f"launch failed ({rc})")

        call()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise SystemExit(f"{label}: the stamped copy disagrees with the kernel")
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(10):
            call()
        e.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(e) / 10
        call()
        torch.cuda.synchronize()
        st = np.zeros((264, SLOTS), dtype=np.int64)
        if lib.stamps_read(st.ctypes.data) != 0:
            raise SystemExit("reading the stamps failed")
        st = st[st[:, 192] > 0]
        n = np.minimum(st[:, 192], MAX_TILES)
        per_block = []
        for row, k in zip(st, n):
            s, f, m, ep = (row[1 + j:1 + 4 * k:4] for j in range(4))
            per_block.append((np.mean(m - s), np.mean(ep - m), np.mean(f - s),
                              row[190] / row[192], row[191] / row[192], row[193] - row[0]))
        mainloop, epilogue, first, wait_a, wait_w, span = np.mean(per_block, axis=0)
        ideal = 27 * 512 * plan.chunks
        print(f"{label} ({cin}->256 at {grid}), stages {args.stages or 4}, cluster "
              f"{args.cluster or default}: {ms:.4f} ms over {len(st)} blocks, "
              f"{st[:, 192].min()}-{st[:, 192].max()} tiles a block, ~{span / ms / 1e3:.0f} MHz; "
              f"a tile: mainloop {mainloop:.0f} clocks (ideal {ideal}, "
              f"{ideal / mainloop:.0%}), waited on weights {wait_w:.0f} and on the halo "
              f"{wait_a:.0f} of it; epilogue {epilogue:.0f}; first stage after {first:.0f}",
              flush=True)


if __name__ == "__main__":
    main()
