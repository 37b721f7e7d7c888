"""The port's tuner (``paddle_tpu_torch.tuner``) against the JAX
package's (its ``tests/test_tuner.py`` read as the spec): the key
grammar equal to the JAX package's on the CPU, the winner store's
integrity rules (a corrupt, truncated, version-mismatched or malformed
cache is ignored with a warning), the memo, disk and defaults tiers,
the ``paged_attn`` family's candidates pruned to B4's limits, B4's chunk
choice under a winner, B4's launch path reading the committed table and
never the disk cache, and a foreign (the JAX package's ``block_h``) or
malformed entry ignored with a warning, leaving the rule's chunking.
Everything on the CPU; the search itself needs the card
(``tests/test_torch_cuda.py``)."""
import json
import os
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu.tuner as jtuner  # noqa: E402
from paddle_tpu.ops.paged_attention import _tuned_block_h  # noqa: E402
import paddle_tpu_torch.tuner as tuner  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.tuner import space, store  # noqa: E402

CPU = torch.device("cpu")
B4 = dict(num_heads=16, head_dim=128, page_size=16, dtype="float32")


@pytest.fixture()
def tune_cache(tmp_path, monkeypatch):
    """Point both packages' winner caches at a fresh dir and reset every
    memo tier."""
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE", str(tmp_path))
    tuner.clear_memo()
    jtuner.clear_memo()
    yield tmp_path
    tuner.clear_memo()
    jtuner.clear_memo()


@pytest.fixture()
def committed_table(tune_cache, monkeypatch):
    """Stand a table of the test's in for the committed defaults:
    ``write({key: config})`` fills it and resets the memos."""
    path = tune_cache / "committed.json"
    monkeypatch.setattr(store, "_DEFAULTS_FILE", str(path))

    def write(entries):
        path.write_text(json.dumps({
            "version": tuner.CACHE_VERSION, "platform": "defaults",
            "entries": {k: {"config": c, "note": "a test's"}
                        for k, c in entries.items()}}))
        tuner.clear_memo()
    return write


def _winners(tmp):
    return os.path.join(str(tmp), "winners-cpu.json")


def _caught(fn):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(x.message) for x in w]


@pytest.mark.parametrize("kind,args,kw", [
    ("flash", (4095, 4095, 64, "bfloat16", True), {}),
    ("flash", (100, 37, 16, "float32", False), {"ring": True}),
    ("flash", (128, 128, 32, "float32", True), {"bwd": True}),
    ("flash", (96, 96, 16, "float16", False), {"ring": True, "bwd": True}),
    ("paged", (16, 128, 16, "float32"), {}),
    ("paged", (12, 64, 16, "bfloat16"), {}),
    ("nms", (400,), {}),
    ("compress", (900_000, "int8"), {}),
    ("compress", (10, "bf16"), {}),
])
def test_keys_equal_the_reference_on_the_cpu(kind, args, kw):
    """The key grammar is the JAX package's, byte for byte, with the
    platform each package names the CPU by (``cpu``)."""
    jfn = getattr(jtuner, f"{kind}_key")
    tfn = getattr(tuner, f"{kind}_key")
    assert tfn(*args, device="cpu", **kw) == jfn(*args, **kw)
    assert tfn(*args, platform="tpu", **kw) == jfn(*args, platform="tpu",
                                                   **kw)


def test_torch_and_numpy_dtypes_spell_as_the_reference():
    for dt, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
                     (torch.float16, "float16"), (np.float32, "float32")):
        assert tuner.paged_key(16, 128, 16, dt, platform="cpu") == \
            jtuner.paged_key(16, 128, 16, name, platform="cpu")


def test_card_tag_keeps_winners_apart(monkeypatch):
    """A card's tag is its compute capability, never the JAX package's
    ``gpu``: an H100's winners live in ``winners-cuda-sm90.json``."""
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda index=None: (9, 0))
    tag = tuner._cuda_tag.__wrapped__(0)
    assert tag == "cuda-sm90" and tag not in ("gpu", "tpu", "cpu")
    assert tuner.platform_tag("cpu") == "cpu"
    assert store.WinnerStore(tag, "/x").path == "/x/winners-cuda-sm90.json"


class TestWinnerStoreIntegrity:
    """Bad caches warn and are ignored; they never crash a lookup."""

    def test_corrupt_file_ignored_with_warning(self, tune_cache):
        with open(_winners(tune_cache), "w") as f:
            f.write("{ this is not json !!")
        cfg, w = _caught(lambda: tuner.get_paged_attn_config(**B4,
                                                             device=CPU))
        assert cfg is None and any("corrupt" in m for m in w)

    def test_truncated_file_ignored_with_warning(self, tune_cache):
        with open(_winners(tune_cache), "w") as f:
            f.write('{"version": 1, "entries": {"paged_attn|cpu')
        cfg, w = _caught(lambda: tuner.get_flash_blocks(
            999, 999, 32, "float32", False, device=CPU))
        assert cfg is None and any("corrupt" in m for m in w)

    def test_version_mismatch_ignored_with_warning(self, tune_cache):
        key = tuner.paged_key(**B4, device=CPU)
        with open(_winners(tune_cache), "w") as f:
            json.dump({"version": tuner.CACHE_VERSION + 1,
                       "entries": {key: {"config": {"blocks_per_sm": 4}}}},
                      f)
        cfg, w = _caught(lambda: tuner.get_paged_attn_config(**B4,
                                                             device=CPU))
        assert cfg is None and any("version" in m for m in w)

    def test_malformed_entries_dropped_good_kept(self, tune_cache):
        key = tuner.paged_key(**B4, device=CPU)
        with open(_winners(tune_cache), "w") as f:
            json.dump({"version": tuner.CACHE_VERSION, "platform": "cpu",
                       "entries": {key: {"config": {"blocks_per_sm": 4}},
                                   "bad1": "not a dict",
                                   "bad2": {"no_config": True}}}, f)
        cfg, w = _caught(lambda: tuner.get_paged_attn_config(**B4,
                                                             device=CPU))
        assert cfg == {"blocks_per_sm": 4}
        assert any("malformed" in m for m in w)

    def test_record_after_corruption_recovers(self, tune_cache):
        path = _winners(tune_cache)
        with open(path, "w") as f:
            f.write("garbage")
        key = tuner.paged_key(**B4, device=CPU)
        _caught(lambda: tuner.record_winner(key, {"blocks_per_sm": 16}))
        tuner.clear_memo()
        assert tuner.get_paged_attn_config(**B4, device=CPU) == \
            {"blocks_per_sm": 16}
        with open(path) as f:
            assert json.load(f)["version"] == tuner.CACHE_VERSION

    @pytest.mark.parametrize("config", [
        {"block_h": 4}, {"blocks_per_sm": 0}, {"blocks_per_sm": "8"},
        {"blocks_per_sm": True}, {}])
    def test_foreign_or_malformed_paged_entry_keeps_the_rule(
            self, committed_table, config):
        """An entry under a B4 key that is not ``{"blocks_per_sm": n>0}``
        (the JAX package's ``block_h`` among them) is ignored with a
        warning, in the disk cache and in the committed table alike; the
        wrapper's lookup gives None, so the chunk rule stands."""
        key = tuner.paged_key(**B4, device=CPU)
        tuner.record_winner(key, config)
        tuner.clear_memo()
        cfg, w = _caught(lambda: tuner.get_paged_attn_config(**B4,
                                                             device=CPU))
        assert cfg is None and any("not a B4 config" in m for m in w)
        committed_table({key: config})
        bps, w = _caught(lambda: tuner.paged_blocks_per_sm(
            16, 128, 16, torch.float32, CPU))
        assert bps is None
        assert any("not a B4 config" in m for m in w)
        rule = pa.chunk_pages_for(64, 128, 132)
        assert pa.chunk_pages_for(64, 128, 132, bps or pa.BLOCKS_PER_SM) \
            == rule == 8


def test_a_shared_cache_keeps_each_package_to_its_own_config(tune_cache):
    """One ``PADDLE_TPU_TUNE_CACHE`` for both packages: the JAX package's
    ``block_h`` winner is not a B4 config to the port, the port's
    ``blocks_per_sm`` winner is no ``block_h`` to the JAX package, and
    each package's rewrite of the shared file keeps the other's entries."""
    jkey = jtuner.paged_key(16, 128, 16, "float32")
    jtuner.record_winner(jkey, {"block_h": 8})
    tuner.clear_memo()
    cfg, w = _caught(lambda: tuner.get_paged_attn_config(**B4, device=CPU))
    assert cfg is None and any("not a B4 config" in m for m in w)
    tkey = tuner.paged_key(12, 64, 16, "float32", device=CPU)
    tuner.record_winner(tkey, {"blocks_per_sm": 4})
    jtuner.clear_memo()
    assert _tuned_block_h(12, 64, 16, "float32") is None
    with open(_winners(tune_cache)) as f:
        entries = json.load(f)["entries"]
    assert entries[jkey]["config"] == {"block_h": 8}
    assert entries[tkey]["config"] == {"blocks_per_sm": 4}


class TestResolutionTiers:
    def test_disk_winner_read_back_after_clear_memo(self, tune_cache):
        """A recorded winner is read back from disk by the lookup, and
        B4's launch path, which reads the committed table alone, keeps
        the rule."""
        key = tuner.paged_key(**B4, device=CPU)
        tuner.record_winner(key, {"blocks_per_sm": 12}, us=31.5)
        assert tuner.get_paged_attn_config(**B4, device=CPU) == \
            {"blocks_per_sm": 12}
        tuner.clear_memo()
        assert store.store_for("cpu").entry(key) == {
            "config": {"blocks_per_sm": 12}, "us": 31.5}
        assert tuner.get_paged_attn_config(**B4, device=CPU) == \
            {"blocks_per_sm": 12}
        assert tuner.paged_blocks_per_sm(16, 128, 16, torch.float32,
                                         CPU) is None

    def test_the_launch_path_reads_the_committed_table_only(
            self, committed_table):
        """B4's target comes from the committed table; a disk winner for
        the same key changes the lookups but never the launch."""
        key = tuner.paged_key(**B4, device=CPU)
        committed_table({key: {"blocks_per_sm": 4}})
        tuner.record_winner(key, {"blocks_per_sm": 24})
        assert tuner.get_paged_attn_config(**B4, device=CPU) == \
            {"blocks_per_sm": 24}
        assert tuner.paged_blocks_per_sm(16, 128, 16, torch.float32,
                                         CPU) == 4
        tuner.clear_memo()
        assert tuner.paged_blocks_per_sm(16, 128, 16, torch.float32,
                                         CPU) == 4
        assert tuner.paged_blocks_per_sm(16, 128, 16, torch.bfloat16,
                                         CPU) is None

    def test_disk_shadows_defaults(self, tune_cache, monkeypatch):
        key = tuner.paged_key(**B4, device=CPU)
        defaults = tune_cache / "defaults.json"
        defaults.write_text(json.dumps({
            "version": 1, "platform": "defaults",
            "entries": {key: {"config": {"blocks_per_sm": 4},
                              "note": "a test's"}}}))
        monkeypatch.setattr(store, "_DEFAULTS_FILE", str(defaults))
        tuner.clear_memo()
        assert tuner.get_paged_attn_config(**B4, device=CPU) == \
            {"blocks_per_sm": 4}
        tuner.record_winner(key, {"blocks_per_sm": 24})
        tuner.clear_memo()
        assert tuner.get_paged_attn_config(**B4, device=CPU) == \
            {"blocks_per_sm": 24}

    def test_the_shipped_defaults_are_the_ports_own(self):
        """The committed table holds only the port's own entries: B4
        configs on a card's tag, none of the JAX package's TPU winners."""
        with open(store._DEFAULTS_FILE) as f:
            table = json.load(f)
        assert table["version"] == tuner.CACHE_VERSION
        for key, entry in table["entries"].items():
            fam, plat = key.split("|")[:2]
            assert fam == "paged_attn" and plat.startswith("cuda-sm")
            assert set(entry["config"]) == {"blocks_per_sm"}
            assert entry.get("note")

    def test_b4_lookup_is_a_tuple_hit_after_the_first(self, committed_table,
                                                      monkeypatch):
        """After a shape's first lookup the launch path formats no key and
        reads no table: a dict hit keyed by a tuple."""
        committed_table({tuner.paged_key(**B4, device=CPU):
                         {"blocks_per_sm": 6}})
        assert tuner.paged_blocks_per_sm(16, 128, 16, torch.float32,
                                         CPU) == 6

        def boom(*a, **k):
            raise AssertionError("the launch path built a key")
        monkeypatch.setattr(tuner, "paged_key", boom)
        monkeypatch.setattr(store, "committed", boom)
        monkeypatch.setattr(tuner, "store_for", boom)
        for _ in range(5):
            assert tuner.paged_blocks_per_sm(16, 128, 16, torch.float32,
                                             CPU) == 6

    def test_memo_avoids_disk_after_first_lookup(self, tune_cache,
                                                 monkeypatch):
        key = tuner.flash_key(64, 64, 16, "float32", False, device=CPU)
        tuner.record_winner(key, {"block_q": 32, "block_k": 32})
        tuner.clear_memo()
        assert tuner.get_flash_blocks(64, 64, 16, "float32", False,
                                      device=CPU) == (32, 32)
        calls = {"n": 0}
        real = store.store_for

        def counting(platform):
            calls["n"] += 1
            return real(platform)
        monkeypatch.setattr(tuner, "store_for", counting)
        for _ in range(5):
            assert tuner.get_flash_blocks(64, 64, 16, "float32", False,
                                          device=CPU) == (32, 32)
        assert calls["n"] == 0

    @pytest.mark.parametrize("get,args,cfg,want", [
        ("get_nms_config", (400,), {"unroll": 4}, {"unroll": 4}),
        ("get_compress_block", (5000,), {"block": 128}, 128),
        ("get_spec_verify_blocks", (4, 512, 64), {"block_q": 16,
                                                  "block_k": 64}, (16, 64)),
    ])
    def test_kept_lookups_match_the_reference(self, tune_cache, get, args,
                                              cfg, want):
        """The families no port kernel reads keep the reference's lookups:
        a winner one package records, the other resolves alike."""
        jkey = {"get_nms_config": lambda: jtuner.nms_key(400),
                "get_compress_block": lambda: jtuner.compress_key(5000),
                "get_spec_verify_blocks": lambda: jtuner.flash_key(
                    5, 512, 64, "float32", True)}[get]()
        jtuner.record_winner(jkey, cfg)
        tuner.clear_memo()
        assert getattr(tuner, get)(*args, device=CPU) == want == \
            getattr(jtuner, get)(*args)


class TestPagedCandidates:
    @pytest.mark.parametrize("s,h,pps,n_sms", [
        (8, 16, 64, 132), (8, 16, 8, 132), (1, 1, 100_000, 2000),
        (64, 32, 4096, 132), (2, 4, 3, 132)])
    def test_pruned_to_the_kernels_limits(self, s, h, pps, n_sms):
        cands = space.paged_attn_candidates(s, h, pps, n_sms)
        assert cands
        chunks = [pa.chunk_pages_for(pps, s * h, n_sms, c["blocks_per_sm"])
                  for c in cands]
        assert len(set(chunks)) == len(chunks)          # one per chunking
        for cp in chunks:
            assert 1 <= cp <= pa.MAX_CHUNK_PAGES
            assert -(-pps // cp) <= space.MAX_CHUNKS
        assert [c["blocks_per_sm"] for c in cands] == \
            sorted(c["blocks_per_sm"] for c in cands)

    def test_the_rules_chunking_is_a_candidate(self):
        cands = space.paged_attn_candidates(8, 16, 64, 132)
        assert {"blocks_per_sm": pa.BLOCKS_PER_SM} in cands
        assert len(cands) > 1

    def test_past_the_chunk_limit_is_pruned(self):
        """100,000 pages on a grid of 2,000 SMs: the targets that would cut
        a sequence into more than 65,535 one-page chunks never launch."""
        pps, n_sms = 100_000, 2000
        kept = {c["blocks_per_sm"]
                for c in space.paged_attn_candidates(1, 1, pps, n_sms)}
        over = {b for b in space.PAGED_BLOCKS_PER_SM
                if -(-pps // pa.chunk_pages_for(pps, 1, n_sms, b))
                > space.MAX_CHUNKS}
        assert over and not (over & kept)


@pytest.mark.parametrize("bps,want", [(None, 8), (8, 8), (1, 32), (4, 13),
                                      (16, 4), (64, 1)])
def test_b4_chunking_under_a_winner(bps, want):
    """B4's split under a winner: GPT-3 1.3B's decode (8 sequences x 16
    heads, 64 pages) on 132 SMs; no winner is the rule's 8 pages."""
    assert pa.chunk_pages_for(64, 128, 132,
                              bps or pa.BLOCKS_PER_SM) == want


def test_search_and_the_fixed_kernels_refuse_on_the_cpu():
    with pytest.raises(RuntimeError, match="no tile"):
        tuner.autotune_paged_attn(8, 16, 128, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="BQ = BK = 64"):
        tuner.autotune_flash(2, 64, 64, 16)
    with pytest.raises(NotImplementedError, match="A10"):
        tuner.autotune_compress(4096)


def test_the_plain_version_ignores_the_target():
    """On the CPU B4 is its plain version: a forced target changes
    nothing, and a bad one is not looked at."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((3, 2, 8)).astype(np.float32))
    ka = torch.from_numpy(rng.standard_normal((7, 4, 2, 8)).astype(
        np.float32))
    va = torch.from_numpy(rng.standard_normal((7, 4, 2, 8)).astype(
        np.float32))
    bt = torch.tensor([[0, 1], [2, 3], [4, 5]], dtype=torch.int32)
    pos = torch.tensor([0, 5, 7], dtype=torch.int32)
    want = pa.paged_attention_plain(q, ka, va, bt, pos)
    for b in (None, 1, 64):
        assert torch.equal(pa.paged_attention(q, ka, va, bt, pos,
                                              blocks_per_sm=b), want)
