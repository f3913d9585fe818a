"""Quickstart for the PyTorch/CUDA port: the Buddy-RAM bulk-bitwise
substrate in five minutes, section by section as `examples/quickstart.py`.

Run:  PYTHONPATH=src python examples/quickstart_torch.py            # card
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu

On the card every bulk op runs the port's CUDA kernels; on the CPU their
plain PyTorch versions.
"""
import argparse

import numpy as np
import torch

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
dev = torch.device(ap.parse_args().device)
gen = torch.Generator(device=dev).manual_seed(0)

# ---- 1. Bulk bitwise ops (the paper's core primitive) ----------------------
from repro_torch.core.bitplane import pack_bits, unpack_bits  # noqa: E402
from repro_torch.ops.bitwise import (bitwise_and, bitwise_or,  # noqa: E402
                                     majority3)

n = 1 << 20                     # 1M-bit vectors
a, b, c = (torch.rand(n, generator=gen, device=dev) < 0.5 for _ in range(3))
pa, pb, pc = pack_bits(a), pack_bits(b), pack_bits(c)   # 32x packed words

x = bitwise_and(pa, pb)
y = bitwise_or(pa, pb)
m = majority3(pa, pb, pc)       # = triple-row activation (TRA)
assert torch.equal(unpack_bits(m, n), (a & b) | (b & c) | (c & a))
print(f"1M-bit AND/OR/MAJ3 on packed planes on {dev}: OK "
      f"({pa.numel() * 4} bytes per operand vs {a.numel()} unpacked)")

# ---- 2. The in-DRAM execution model (AAP programs, Fig. 8) -----------------
from repro_torch.core.compiler import and_program  # noqa: E402
from repro_torch.core.timing import DDR3_1600, program_latency_ns  # noqa

prog = and_program("D0", "D1", "D2")
print(f"\nBuddy 'Dk = Di and Dj' as an AAP program "
      f"({len(prog.commands)} commands):")
for cmd in prog.commands:
    print("   ", cmd)
lat = program_latency_ns(prog, DDR3_1600)
print(f"latency (split row decoder): {lat:.0f} ns for an 8KB row — vs "
      f"~{3 * 8192 / 12.8:.0f} ns to even move 3 rows over a DDR3-1600 "
      f"channel")

# ---- 2b. The fusing compiler + multi-bank engine ---------------------------
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core.compiler import (Expr, compile_expr,  # noqa: E402
                                       compile_expr_fused)

ea, eb, ec = Expr.of("D0"), Expr.of("D1"), Expr.of("D2")
maj_expr = (ea & eb) | (eb & ec) | (ec & ea)
unfused = compile_expr(maj_expr, "OUT")
fused = compile_expr_fused(maj_expr, "OUT")
print(f"\nfusing compiler: majority-of-3 DAG lowers to "
      f"{len(fused.program.commands)} commands fused vs "
      f"{len(unfused.program.commands)} unfused (one native TRA)")

rows_data = {f"D{i}": np.random.default_rng(i).integers(
    0, 2**32, 4096, dtype=np.uint32) for i in range(3)}
out_1 = eng.execute(fused.program, rows_data, outputs=["OUT"],
                    device=dev)["OUT"]
out_8 = eng.execute(fused.program, rows_data, outputs=["OUT"], n_banks=8,
                    device=dev)["OUT"]
assert torch.equal(out_1, out_8)
print("multi-bank engine: 8-bank execution == single-bank, bit-exact")

# ---- 3. Buddy as a data-curation stage (bitmap-index pipeline) -------------
from repro_torch.data.bitmap_filter import (CorpusCatalog,  # noqa: E402
                                            build_filter, sample_eligible)

cat = CorpusCatalog.synthetic(gen, n_docs=100_000)
bitmap, n_ok = build_filter(
    cat, require=("lang_en", "quality_hi", "dedup_canonical"),
    exclude=("toxic",), ranges={"n_tokens": (256, 4095)})
ids = sample_eligible(gen, bitmap, cat.n_docs, batch=64)
assert bool(unpack_bits(bitmap, cat.n_docs)[ids.long()].all())
print(f"\ncorpus filter: {n_ok}/{cat.n_docs} documents eligible "
      f"(evaluated as bulk bitwise ops over packed bitmaps); 64 sampled")

# ---- 3b. The query service: submit()/QueryHandle over a catalog ------------
from repro_torch.service import (Arrival, Query, QueryService,  # noqa: E402
                                 ServiceConfig, SloConfig)

svc = QueryService(ServiceConfig(n_banks=8, slo=SloConfig(p99_ns=5e6),
                                 device=str(dev)))
rng = np.random.default_rng(7)
for name in ("mon", "tue", "wed"):
    svc.register_bits(name, rng.random(1 << 12) < 0.4, group="days")

h = svc.submit("mon & tue", tenant="analytics")     # -> QueryHandle
assert h.done()
print(f"\nservice: |mon & tue| = {h.result().scalar} "
      f"(async handle, resolved eagerly without a serving loop)")

# the same handles flow through the continuous-serving runtime
loop = svc.serve_loop(depth=2)
trace = [Arrival(t_ns=i * 20_000.0,
                 query=Query("mon & tue | wed", tenant="analytics"))
         for i in range(8)]
rep = loop.run_trace(trace)
print(f"serving loop: {len(rep.served)} served in {len(rep.ticks)} ticks, "
      f"{rep.sustained_qps:.0f} modeled qps, "
      f"p99 sojourn {rep.sojourn_percentile_ns(99) / 1e3:.1f} us")

# ---- 4. Majority-vote 1-bit gradient compression (TRA as a collective) -----
from repro_torch.optim.signum import pack_tree, unpack_tree  # noqa: E402

g = {"w": torch.randn(1000, generator=gen, device=dev)}
packed, meta = pack_tree(g)
signs = unpack_tree(packed, meta)
assert torch.equal(signs["w"], torch.where(g["w"] < 0, -1.0, 1.0))
print(f"\nsign-compressed gradient: {g['w'].numel() * 4} B -> "
      f"{packed.numel() * 4} B (32x), majority-vote aggregated across "
      f"data-parallel workers")

# ---- 5. The paper's analog model, bop dispatch and §8.4 applications -------
from repro_torch.core.isa import BuddyDevice  # noqa: E402
from repro_torch.core.spice import monte_carlo_tra, table1  # noqa: E402
from repro_torch.ops import dna  # noqa: E402
from repro_torch.ops.bloom import BloomFilter  # noqa: E402
from repro_torch.ops.crypto import xor_decrypt, xor_encrypt  # noqa: E402

fails = [(case, v) for case, row in table1(device=dev).items()
         for v, e in row.items() if e["fails"]]
mc = monte_carlo_tra(gen, 1 << 16, 0.06)
print(f"\nTable 1: TRA fails only at {fails}; Monte-Carlo failure rate at "
      f"6% variation {float(mc['failure_rate']):.4f}")
bd = BuddyDevice(row_bits=1024, device=dev)
for i, (name, group) in enumerate((("a", "g0"), ("b", "g0"), ("c", "g1"),
                                   ("d", "g2"))):
    bd.store(name, np.random.default_rng(i).integers(0, 2**32, 32,
                                                     dtype=np.uint32),
             group=group)
paths = [bd.bop("and", "o1", ["a", "b"], group="g0").path,
         bd.bop("maj3", "o2", ["a", "c", "d"], group="g3").path]
print(f"bop dispatch (§6.2.2): same subarray -> {paths[0]}, "
      f"3 PSM copies -> {paths[1]}")
pt = torch.randint(0, 2**31 - 1, (4096,), generator=gen, device=dev,
                   dtype=torch.int32)
assert torch.equal(xor_decrypt(xor_encrypt(pt, 0xDEADBEEF), 0xDEADBEEF), pt)
genome = torch.randint(0, 4, (1 << 16,), generator=gen, device=dev)
hits = dna.find_matches(genome, genome[1234:1250].tolist())
assert bool(hits.to_bits()[1234])
bloom = BloomFilter.create(1 << 16, k=4, device=dev).insert(
    np.arange(1000, dtype=np.uint32))
assert bool(bloom.query(np.arange(1000, dtype=np.uint32)).all())
print(f"XOR cipher round trip, DNA read found at 1234 "
      f"({int(hits.popcount())} hits), Bloom filter "
      f"{float(bloom.fill_ratio()):.3f} full: OK")
print("\nquickstart OK")
