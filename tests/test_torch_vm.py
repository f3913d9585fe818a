"""Port parity: the opcode-table VM and the micro-op interpreter.

The port's `execute_lowered` (plain ``"torch"`` VM, and the ``"cuda"``
wrapper, which runs the plain VM for CPU tensors) against the JAX
package's `execute_lowered` on its ``"scan"`` backend and against the
port's own interpreter, bit for bit: random TRA / copy / not / raw-AAP
programs (the generator of tests/test_property_lowering.py, built in
both packages), every reduce mode, shared and per-batch masks, batch
axes, and TRA fault masks. One small case runs the reference's Pallas
megakernel in interpret mode. The program the CUDA kernel runs
(`kernels.vm.program`: the pre-decoded, encoded table) is run word for
word by a numpy interpreter, `run_encoded`, and held to `vm_plain` on
the raw table."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import commands as rcmd
from repro.core import compiler as rcomp
from repro.core import engine as reng
from repro.core import lowering as rlow
from repro.core.errors import TRAErrorModel, error_planes
from repro_torch.convert import lowered_from_reference
from repro_torch.core import commands as tcmd
from repro_torch.core import compiler as tcomp
from repro_torch.core import engine as teng
from repro_torch.core import lowering as tlow
from repro_torch.core.bitplane import as_words, to_uint32
from repro_torch.kernels import vm

N_ROWS = 8      # D-row pool; programs draw operands from D0..D7
_PRIMS = ["and", "or", "nand", "nor", "xor", "xnor", "maj3", "andnot",
          "not", "copy", "zero", "one"]
_RAW_ADDR1 = [f"D{i}" for i in range(N_ROWS)] + \
    ["B0", "B1", "B2", "B3", "B4", "B5", "B6", "B7",
     "B12", "B13", "B14", "B15", "C0", "C1"]
_RAW_ADDR2 = _RAW_ADDR1 + ["B8", "B9", "B10", "B11"]


def _random_program(rng, compiler, cmd):
    """A random valid AAP/AP program, drawn the same way for either
    package (`compiler` / `cmd` are that package's modules)."""
    cmds = []
    for _ in range(int(rng.integers(1, 12))):
        kind = int(rng.integers(0, 3))
        if kind == 0:       # a primitive op program over random D rows
            op = _PRIMS[int(rng.integers(len(_PRIMS)))]
            rows = [f"D{int(i)}" for i in rng.integers(0, N_ROWS, 4)]
            if op in ("not", "copy"):
                prog = getattr(compiler, f"{op}_program")(rows[0], rows[1])
            elif op in ("zero", "one"):
                prog = getattr(compiler, f"{op}_program")(rows[0])
            elif op == "maj3":
                prog = compiler.maj3_program(*rows)
            else:
                prog = getattr(compiler, f"{op}_program")(*rows[:3])
            cmds.extend(prog.commands)
        elif kind == 1:     # raw AAP over any legal address pair
            a1 = _RAW_ADDR1[int(rng.integers(len(_RAW_ADDR1)))]
            a2 = _RAW_ADDR2[int(rng.integers(len(_RAW_ADDR2)))]
            cmds.append(cmd.AAP(a1, a2))
        else:               # raw AP (destructive TRA or a no-op restore)
            cmds.append(cmd.AP(_RAW_ADDR1[int(rng.integers(len(_RAW_ADDR1)))]))
    return cmd.Program(cmds, "random")


def _programs(seed):
    return (_random_program(np.random.default_rng(seed), rcomp, rcmd),
            _random_program(np.random.default_rng(seed), tcomp, tcmd))


def _assert_rows_equal(want, got):
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(to_uint32(got[k]),
                                      np.asarray(want[k]), err_msg=k)


BATCHES = [(), (3,), (2, 2)]


@pytest.mark.parametrize("seed", range(20))
def test_random_programs_match_reference_and_interpreter(seed):
    rprog, tprog = _programs(seed)
    rng = np.random.default_rng(seed + 1000)
    batch = BATCHES[seed % len(BATCHES)]
    words = int(rng.integers(1, 70))
    data = {f"D{i}": rng.integers(0, 1 << 32, batch + (words,),
                                  dtype=np.uint32)
            for i in range(int(rng.integers(1, N_ROWS + 1)))}
    want = reng.execute(rprog, data, lowered=True, backend="scan")
    interp = teng.execute(tprog, data, lowered=False, device="cpu")
    _assert_rows_equal(want, interp)
    for backend in ("torch", "cuda"):
        _assert_rows_equal(want, teng.execute(tprog, data, lowered=True,
                                              backend=backend, device="cpu"))


def _ref_counts(rows, outs, mask):
    """Per-output popcounts of the reference's materialized rows."""
    def pc(w):
        return np.unpackbits(np.ascontiguousarray(w).view(np.uint8),
                             axis=-1).sum(-1)
    return {k: pc(np.asarray(rows[k]) if mask is None
                  else np.asarray(rows[k]) & mask) for k in outs}


@pytest.mark.parametrize("seed", range(12))
def test_reduce_modes_masks_and_faults_match_reference(seed):
    """Rows from the reference's scan VM (with and without its seeded TRA
    fault masks); counts are their popcounts, which the reference's own
    suite holds equal to its fused epilogue."""
    rprog, tprog = _programs(seed)
    rlp, tlp = rlow.lower(rprog), tlow.lower(tprog)
    assert np.array_equal(rlp.table, tlp.table)
    # a program that writes no D/C row still counts its passthrough rows
    outs = [r for r in rlp.writes if r != rlow.SINK] or ["D0"]
    rng = np.random.default_rng(seed)
    batch = BATCHES[seed % len(BATCHES)]
    words = 45
    data = {f"D{i}": rng.integers(0, 1 << 32, batch + (words,),
                                  dtype=np.uint32) for i in range(4)}
    shared = rng.integers(0, 1 << 32, (words,), dtype=np.uint32)
    per_batch = rng.integers(0, 1 << 32, batch + (words,), dtype=np.uint32)
    errors = np.asarray(error_planes(rlp.table, jax.random.PRNGKey(seed),
                                     batch, words,
                                     TRAErrorModel(p_flip=0.05)))
    for err in (None, errors):
        want = rlow.execute_lowered(rlp, data, words, outs, backend="scan",
                                    errors=err)
        for backend in ("torch", "cuda"):
            got = tlow.execute_lowered(tlp, data, words, outs,
                                       backend=backend, errors=err)
            _assert_rows_equal(want, got)
            for mask in (None, shared, per_batch):
                counts = _ref_counts(want, outs, mask)
                got = tlow.execute_lowered(tlp, data, words, outs,
                                           backend=backend, errors=err,
                                           reduce="popcount", mask=mask)
                assert set(got) == set(outs)
                for k in outs:
                    np.testing.assert_array_equal(got[k].numpy(), counts[k],
                                                  err_msg=k)
                agg = tlow.execute_lowered(tlp, data, words, outs,
                                           backend=backend, errors=err,
                                           reduce="aggregate", mask=mask)
                # small integer counts: the float32 weighting is exact
                np.testing.assert_array_equal(
                    agg.numpy(), sum(counts[k].astype(np.float32) * (1 << j)
                                     for j, k in enumerate(outs)))


def test_passthrough_and_seeded_fixed_rows_match_reference():
    rng = np.random.default_rng(5)
    e = rcomp.Expr
    r = rcomp.compile_expr_fused(e.of("D0") & e.of("D1"), "OUT").program
    t = tcomp.compile_expr_fused(
        tcomp.Expr.of("D0") & tcomp.Expr.of("D1"), "OUT").program
    data = {n: rng.integers(0, 1 << 32, (2, 9), dtype=np.uint32)
            for n in ("D0", "D1", "EXTRA", "T0", "C1")}
    # seeded reserved rows and a requested output the program never writes
    outs = ["OUT", "EXTRA"]
    want = rlow.execute_lowered(rlow.lower(r), data, outputs=outs)
    got = tlow.execute_lowered(tlow.lower(t), data, outputs=outs)
    _assert_rows_equal(want, got)
    mask = rng.integers(0, 1 << 32, (9,), dtype=np.uint32)
    want = rlow.execute_lowered(rlow.lower(r), data, outputs=outs,
                                reduce="popcount", mask=mask)
    got = tlow.execute_lowered(tlow.lower(t), data, outputs=outs,
                               backend="cuda", reduce="popcount", mask=mask)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # outputs=None returns exactly the rows the interpreter would
    _assert_rows_equal(reng.execute(r, data, lowered=False),
                       teng.execute(t, data, lowered=True, device="cpu"))


def test_matches_reference_pallas_megakernel_interpret_mode():
    """One small case against the reference's Pallas VM (interpret mode on
    the CPU), fused popcount and materialize, multi-block."""
    rprog, tprog = _programs(3)
    rlp = rlow.lower(rprog)
    outs = [r for r in rlp.writes if r != rlow.SINK]
    rng = np.random.default_rng(3)
    data = {f"D{i}": rng.integers(0, 1 << 32, (2, 20), dtype=np.uint32)
            for i in range(4)}
    want = rlow.execute_lowered(rlp, data, outputs=outs, backend="pallas")
    got = tlow.execute_lowered(tlow.lower(tprog), data, outputs=outs,
                               backend="cuda")
    _assert_rows_equal(want, got)
    mask = rng.integers(0, 1 << 32, (20,), dtype=np.uint32)
    want = rlow.execute_lowered(rlp, data, outputs=outs, backend="pallas",
                                reduce="popcount", mask=mask)
    got = tlow.execute_lowered(tlow.lower(tprog), data, outputs=outs,
                               backend="cuda", reduce="popcount", mask=mask)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_subarray_run_matches_reference_interpreter():
    rprog, tprog = _programs(11)
    rng = np.random.default_rng(11)
    data = {f"D{i}": rng.integers(0, 1 << 32, (17,), dtype=np.uint32)
            for i in range(N_ROWS)}
    r = reng.Subarray.create(17, {k: jnp.asarray(v) for k, v in data.items()})
    t = teng.Subarray.create(17, data)
    rr, tt = r.run(rprog), t.run(tprog)
    assert set(rr.rows) == set(tt.rows)
    for k in rr.rows:
        np.testing.assert_array_equal(to_uint32(tt.rows[k]),
                                      np.asarray(rr.rows[k]), err_msg=k)
    with pytest.raises(teng.BuddyError):
        teng.Subarray.create(4).run(tcmd.Program([tcmd.AP("B8")], "bad"))


def test_vm_plain_first_row_contract():
    """A plane holding the reserved rows (first_row=0) and one holding only
    the data block (first_row=9) run identically."""
    rprog, tprog = _programs(7)
    lp = lowered_from_reference(rlow.lower(rprog))
    assert np.array_equal(lp.table, tlow.lower(tprog).table)
    rng = np.random.default_rng(7)
    data = {f"D{i}": rng.integers(0, 1 << 32, (3, 33), dtype=np.uint32)
            for i in range(N_ROWS)}
    call = tlow.vm_call(lp, data)
    assert call.first_row == tlow.N_RESERVED
    head = torch.zeros((3, tlow.N_RESERVED, 33), dtype=torch.int32)
    head[:, tlow.C1_IDX] = -1
    full_plane = torch.cat([head, call.plane], dim=1)
    idx = call.lay.out_idx
    a = vm.vm_plain(call.lay.table, call.plane, idx, n_rows=call.lay.n_rows,
                    first_row=tlow.N_RESERVED)
    b = vm.vm_plain(call.lay.table, full_plane, idx, n_rows=call.lay.n_rows,
                    first_row=0)
    assert torch.equal(a, b)
    assert torch.equal(vm.vm_megakernel(call.lay.table, call.plane, idx,
                                        n_rows=call.lay.n_rows,
                                        first_row=tlow.N_RESERVED), a)


def test_vm_argument_checks_and_block_choice():
    table = np.array([[0, 9, 9, 9, (10 << 16)]], dtype=np.int32)
    plane = torch.zeros((2, 1, 40), dtype=torch.int32)
    ok = dict(n_rows=11, first_row=9)
    assert vm.vm_plain(table, plane, (10,), **ok).shape == (2, 1, 40)
    bad = [
        dict(table=table, plane=plane.long(), out_idx=(10,), kw=ok),
        dict(table=table, plane=plane, out_idx=(11,), kw=ok),
        dict(table=table, plane=plane, out_idx=(10,),
             kw=dict(n_rows=9, first_row=9)),
        dict(table=np.array([[0, 12, 9, 9, 0]], np.int32), plane=plane,
             out_idx=(10,), kw=ok),
        dict(table=table, plane=plane, out_idx=(10,),
             kw=dict(ok, reduce="count")),
        dict(table=table, plane=plane, out_idx=(10,),
             kw=dict(ok, mask=torch.zeros((1, 40), dtype=torch.int32))),
        dict(table=table, plane=plane, out_idx=(10,),
             kw=dict(ok, reduce="popcount",
                     mask=torch.zeros((3, 40), dtype=torch.int32))),
        dict(table=table, plane=plane, out_idx=(10,),
             kw=dict(ok, errors=torch.zeros((2, 3, 40), dtype=torch.int32))),
    ]
    for case in bad:
        for fn in (vm.vm_plain, vm.vm_megakernel):
            with pytest.raises(ValueError):
                fn(case["table"], case["plane"], case["out_idx"],
                   **case["kw"])
    # the first (threads, words a thread) whose shared rows, program and
    # count slots fit as often per SM as the shape asks: two 16-byte quads
    # a thread while two blocks fit an SM, then one quad, then one block,
    # then one word; with fault masks one word a thread, the most threads
    # that fit
    assert vm.block_cols(12, 24, 1) == (128, 8)
    assert vm.block_cols(32, 800, 8) == (128, 4)
    assert vm.block_cols(100, 400, 1) == (64, 4)
    assert vm.block_cols(400, 40, 1) == (32, 4)
    assert vm.block_cols(1800, 40, 1) == (32, 1)
    assert vm.block_cols(35, 956, 8, faulty=True) == (256, 1)
    assert vm.block_cols(900, 40, 1, faulty=True) == (64, 1)
    for faulty in (False, True):
        with pytest.raises(ValueError):
            vm.block_cols(2000, 40, 1, faulty)
    # words are the reference's bits
    assert np.array_equal(to_uint32(as_words(np.uint32([7]))), [7])


def test_row_lists_build_the_plane_in_one_copy():
    """Per-batch row lists (the scheduler's per-query operands) give the
    same plane and results as stacked rows; the plain VM is refused for
    tensors off the CPU."""
    rprog, tprog = _programs(9)
    lp = tlow.lower(tprog)
    rng = np.random.default_rng(9)
    stacked = {f"D{i}": as_words(rng.integers(0, 1 << 32, (3, 21),
                                              dtype=np.uint32))
               for i in range(N_ROWS)}
    lists = {k: list(v.unbind(0)) for k, v in stacked.items()}
    lists["D0"] = stacked["D0"]          # tensors and lists mix
    assert torch.equal(tlow.vm_call(lp, lists).plane,
                       tlow.vm_call(lp, stacked).plane)
    for reduce in (None, "popcount"):
        mask = None if reduce is None else stacked["D1"][0]
        want = tlow.execute_lowered(lp, stacked, reduce=reduce, mask=mask)
        got = tlow.execute_lowered(lp, lists, reduce=reduce, mask=mask)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="holds 1 rows"):
        tlow.vm_call(lp, dict(lists, D1=lists["D1"][:1]))
    meta = {k: v.to("meta") for k, v in stacked.items()}
    with pytest.raises(ValueError, match="plain VM"):
        tlow.execute_lowered(lp, meta, backend="torch")


def run_encoded(prog, plane, n_cmds, errors=None, mask=None, reduce=None,
                seed=0):
    """A numpy interpreter of the kernel's encoded program
    (`kernels.vm.encode`), word for word as ``csrc/vm.cu`` reads it.
    Every shared slot starts as random garbage, so a row the program reads
    before a kept write (or a dropped write that was read) shows."""
    dec, unit = prog.dec, prog.threads * prog.words
    words = prog.buf.numpy().astype(np.int64) & 0xFFFFFFFF
    ones = np.uint32(0xFFFFFFFF)
    plane = to_uint32(plane)
    batch, _, width = plane.shape
    n_load, n_out = len(dec.loads), len(dec.outs)
    out_at = (2 * n_load + 3) // 4 * 4
    cmd_at = out_at + (n_out + 3) // 4 * 4
    sh = np.random.default_rng(seed).integers(
        0, 1 << 32, (dec.n_slots, batch, width), dtype=np.uint32)
    for k in range(n_load):
        off, row = words[2 * k], words[2 * k + 1]
        assert off % unit == 0
        sh[off // unit] = plane[:, row]
    prev = None

    def row(offset):
        assert offset % unit == 0
        return sh[offset // unit]

    def fetch(w, first=None):
        pol = ones if w & vm.POL else np.uint32(0)
        if w & vm.CONST:
            return np.full((batch, width), pol, dtype=np.uint32)
        if w & vm.DUP:
            assert first is not None
            return first ^ pol
        if w & vm.REG:
            assert prev is not None
            return prev ^ pol
        return row(w & vm.SLOT) ^ pol

    err = None if errors is None else to_uint32(errors)
    c = cmd_at
    while c < len(words):
        header, s_words = words[c], words[c + 1:c + 4]
        c += 4
        if err is None:
            assert not any(w & (vm.REG | vm.DUP) for w in s_words)
            assert not (s_words[1] | s_words[2]) & vm.POL
        s0 = fetch(s_words[0])
        s1, s2 = fetch(s_words[1], s0), fetch(s_words[2], s0)
        v = (s0 & s1) | (s1 & s2) | (s2 & s0)
        if err is not None:
            e = err[:, 4 * (header & vm.INDEX):4 * (header & vm.INDEX) + 4]
            ones3, lit = s0 & s1 & s2, s0 | s1 | s2
            v = v ^ ((e[:, 0] & ~lit) | (e[:, 1] & (lit & ~v))
                     | (e[:, 2] & (v & ~ones3)) | (e[:, 3] & ones3))
        n_writes = header >> vm.WRITES_SHIFT
        for w in words[c:c + n_writes]:
            row(w & vm.SLOT)[...] = v ^ (ones if w & vm.POL
                                         else np.uint32(0))
        c += (n_writes + 3) // 4 * 4
        prev = v
    rows = np.stack([fetch(words[out_at + k]) for k in range(n_out)], 1)
    if reduce is None:
        return rows
    if mask is not None:
        rows = rows & to_uint32(mask)[:, None, :]
    return np.unpackbits(rows.view(np.uint8), axis=-1).sum(-1)


def _decoded_matches_plain(lp_table, plane, out_idx, n_rows, first_row,
                           errors, reduce, mask):
    want = vm.vm_plain(lp_table, plane, out_idx, n_rows=n_rows,
                       first_row=first_row, errors=errors, reduce=reduce,
                       mask=mask)
    prog = vm.program(np.asarray(lp_table, np.int32), tuple(out_idx),
                      n_rows, first_row, plane.shape[1], errors is not None,
                      reduce is not None and mask is not None,
                      torch.device("cpu"))
    got = run_encoded(prog, plane, lp_table.shape[0], errors, mask, reduce)
    if reduce is None:
        np.testing.assert_array_equal(got, to_uint32(want))
    else:
        np.testing.assert_array_equal(got, want.numpy())
    return prog


@pytest.mark.parametrize("seed", range(16))
def test_decoded_program_matches_plain_vm(seed):
    """The pre-decoded program, run by `run_encoded`, equals `vm_plain` on
    the raw table: random programs, every output row or a few, seeded
    fixed rows or not, fault masks, both modes and both masks."""
    _, tprog = _programs(seed)
    lp = tlow.lower(tprog)
    rng = np.random.default_rng(seed + 500)
    batch, width = 1 + seed % 3, int(rng.integers(1, 40))
    data = {f"D{i}": rng.integers(0, 1 << 32, (batch, width),
                                  dtype=np.uint32)
            for i in range(int(rng.integers(1, N_ROWS + 1)))}
    if seed % 4 == 1:
        data["T1"] = rng.integers(0, 1 << 32, (batch, width),
                                  dtype=np.uint32)
    outs = [r for r in lp.writes if r != tlow.SINK] or ["D0"]
    if seed % 2:
        outs = outs[:2] + ["D0"]
    call = tlow.vm_call(lp, data, outputs=outs)
    lay = call.lay
    errors = torch.from_numpy(
        (rng.integers(0, 1 << 32, (batch, 4 * lay.table.shape[0], width),
                      dtype=np.uint32)
         & rng.integers(0, 1 << 32, (batch, 4 * lay.table.shape[0], width),
                        dtype=np.uint32)).view(np.int32))
    shared = as_words(rng.integers(0, 1 << 32, (1, width), dtype=np.uint32))
    per_batch = as_words(rng.integers(0, 1 << 32, (batch, width),
                                      dtype=np.uint32))
    for err in (None, errors):
        for reduce, mask in ((None, None), ("popcount", None),
                             ("popcount", shared), ("popcount", per_batch)):
            _decoded_matches_plain(lay.table, call.plane, lay.out_idx,
                                   lay.n_rows, call.first_row, err, reduce,
                                   mask)


@pytest.mark.parametrize("faulty", [False, True])
def test_decoded_program_matches_plain_vm_on_the_section8_stream(faulty):
    """Every VM launch of the §8 multi-tenant stream (weekly OR trees,
    ``sum(col + col2)`` adders, range scans, their shared planes, counts
    and materialized rows), as the scheduler makes them on a small CPU
    service: the decoded program equals `vm_plain`, without and with
    fault masks."""
    from repro_torch.apps.bitmap_index import week_or
    from repro_torch.service import (MATERIALIZE, Query, WorkloadSpec,
                                     build_service, query_stream)

    calls = []
    orig = vm.vm_megakernel

    def record(table, plane, out_idx, **kw):
        calls.append((np.asarray(table), plane, tuple(out_idx), kw))
        return orig(table, plane, out_idx, **kw)

    spec = WorkloadSpec(n_tenants=4, n_weeks=3, domain_bits=(1 << 12) + 37,
                        n_queries=96)
    svc = build_service(spec, device="cpu")
    vm.vm_megakernel = record
    try:
        svc.query_batch(query_stream(spec, svc))
        svc.query_batch([Query(week_or(1, prefix="t1/"), MATERIALIZE),
                         Query("t2/col + t2/col2", MATERIALIZE)])
    finally:
        vm.vm_megakernel = orig
    assert len(calls) > 20
    assert any(kw.get("reduce") is None for *_, kw in calls)
    assert any(kw.get("mask") is not None for *_, kw in calls)
    assert max(t.shape[0] for t, *_ in calls) > 100     # the 8-bit adder
    rng = np.random.default_rng(17)
    for table, plane, out_idx, kw in calls:
        errors = None
        if faulty:
            shape = (plane.shape[0], 4 * table.shape[0], plane.shape[2])
            errors = torch.from_numpy(
                (rng.integers(0, 1 << 32, shape, dtype=np.uint32)
                 & rng.integers(0, 1 << 32, shape, dtype=np.uint32))
                .view(np.int32))
        _decoded_matches_plain(table, plane, out_idx, kw["n_rows"],
                               kw["first_row"], errors, kw.get("reduce"),
                               kw.get("mask"))
