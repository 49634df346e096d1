"""Utility-layer tests: filters, progress, tracing."""

import io
import logging

import numpy as np
import pytest

from grav1synth.bitio import BitReader
from grav1synth.utils.filters import KERNELS, FilterChain
from grav1synth.utils.progress import Progress
from grav1synth.utils.trace import field_tracer, trace_log


class TestFilters:
    def _planes(self, h=64, w=64):
        rng = np.random.default_rng(0)
        y = rng.integers(0, 255, (h, w)).astype(np.uint8)
        u = rng.integers(0, 255, (h // 2, w // 2)).astype(np.uint8)
        v = rng.integers(0, 255, (h // 2, w // 2)).astype(np.uint8)
        return [y, u, v]

    def test_parse_dsl(self):
        chain = FilterChain.parse(
            "crop:top=8,bottom=4;resize:width=32,height=16,alg=lanczos"
        )
        assert len(chain.filters) == 2

    def test_bad_filter_name(self):
        with pytest.raises(ValueError):
            FilterChain.parse("sharpen:amount=2")

    def test_bad_resize_alg(self):
        with pytest.raises(ValueError):
            FilterChain.parse("resize:width=2,height=2,alg=bogus")

    def test_crop(self):
        chain = FilterChain.parse("crop:top=8,bottom=8,left=4,right=4")
        out = chain.apply(self._planes(), 8)
        assert out[0].shape == (48, 56)
        assert out[1].shape == (24, 28)  # chroma at half rate

    @pytest.mark.parametrize("alg", sorted(KERNELS))
    def test_resize_kernels(self, alg):
        chain = FilterChain.parse(f"resize:width=32,height=32,alg={alg}")
        out = chain.apply(self._planes(), 8)
        assert out[0].shape == (32, 32)
        assert out[1].shape == (16, 16)
        assert out[0].dtype == np.uint8

    def test_resize_identity_on_constant(self):
        planes = [np.full((64, 64), 77, np.uint8)] * 3
        chain = FilterChain.parse("resize:width=48,height=48")
        out = chain.apply(planes, 8)
        assert (out[0] == 77).all()

    def test_upscale(self):
        chain = FilterChain.parse("resize:width=128,height=96")
        out = chain.apply(self._planes(), 8)
        assert out[0].shape == (96, 128)


class TestProgress:
    def test_hidden_when_not_tty(self):
        buf = io.StringIO()  # not a tty
        bar = Progress(total=10, out=buf)
        for _ in range(10):
            bar.step()
        bar.done()
        assert buf.getvalue() == ""

    def test_counts(self):
        bar = Progress(total=5, enabled=False)
        for _ in range(5):
            bar.step()
        assert bar.count == 5


class TestTrace:
    def test_field_tracer_logs_positions(self, caplog):
        r = BitReader(bytes([0b1010_1100]))
        r.trace = field_tracer(0)
        with caplog.at_level(logging.DEBUG, logger="trace_headers"):
            r.f(3, "alpha")
            r.f(5, "beta")
        msgs = [rec.getMessage() for rec in caplog.records]
        # reference trace.rs:37-49 layout: pos left-12, name+binary
        # padded to column 60
        assert msgs == [
            "0           alpha" + "101".rjust(55) + " = 5",
            "3           beta" + "01100".rjust(56) + " = 12",
        ]

    def test_zero_overhead_without_hook(self):
        r = BitReader(b"\xff")
        assert r.trace is None
        assert r.f(8, "named") == 255


class TestPrefetch:
    def test_order_and_completion(self):
        from grav1synth.utils.prefetch import PrefetchIterator

        out = list(PrefetchIterator(iter(range(1000)), depth=7))
        assert out == list(range(1000))

    def test_exception_propagates(self):
        from grav1synth.utils.prefetch import PrefetchIterator

        def gen():
            yield 1
            raise ValueError("boom")

        it = PrefetchIterator(gen(), depth=2)
        assert next(it) == 1
        import pytest

        with pytest.raises(ValueError, match="boom"):
            for _ in it:
                pass

    def test_close_unblocks_producer(self):
        import itertools

        from grav1synth.utils.prefetch import PrefetchIterator

        it = PrefetchIterator(itertools.count(), depth=2)
        assert next(it) == 0
        it.close()  # must not hang on the infinite producer

    def test_maybe_prefetch_env_override(self, monkeypatch):
        from grav1synth.utils import prefetch

        monkeypatch.setenv("GRAV1_PREFETCH", "0")
        it = prefetch.maybe_prefetch(iter([1, 2]), depth=2)
        assert isinstance(it, prefetch._Passthrough)
        assert list(it) == [1, 2]
        monkeypatch.setenv("GRAV1_PREFETCH", "1")
        it = prefetch.maybe_prefetch(iter([3]), depth=2)
        assert isinstance(it, prefetch.PrefetchIterator)
        assert list(it) == [3]


class TestCompileCache:
    def test_env_dir_wins(self, monkeypatch, tmp_path):
        from grav1synth.utils import compile_cache

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.compile_cache_dir() == str(tmp_path)

    def test_default_is_fixed_in_checkout(self, monkeypatch):
        import os

        from grav1synth.utils import compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.compile_cache_dir()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert compile_cache.compile_cache_dir() == path  # no per-run part

    @pytest.mark.parametrize("env_set", [True, False])
    def test_setup_sets_only_the_default(self, monkeypatch, tmp_path, env_set):
        import jax

        from grav1synth.utils import compile_cache

        calls = {}
        monkeypatch.setattr(
            jax.config, "update", lambda k, v: calls.__setitem__(k, v)
        )
        monkeypatch.setattr(compile_cache, "DEFAULT_DIR", str(tmp_path / "c"))
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "e"))
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.setup_compile_cache()
        if env_set:
            assert path == str(tmp_path / "e")
            assert "jax_compilation_cache_dir" not in calls
        else:
            assert path == str(tmp_path / "c")
            assert calls["jax_compilation_cache_dir"] == path
            assert (tmp_path / "c").is_dir()


def _worker_platforms():
    import jax

    return jax.config.jax_platforms


class TestHostShardWorkers:
    def test_workers_pinned_to_cpu(self, monkeypatch):
        """The spawn pools of apply/inspect/remove --shards never take a
        device: each worker pins JAX to the CPU before any use."""
        from grav1synth.parallel import host_shard

        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
        with host_shard._pool(1) as pool:
            assert pool.apply(_worker_platforms) == "cpu"
