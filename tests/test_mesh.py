"""Mesh/memory accounting: fold-factor decision logic."""

import numpy as np
import pytest

from gpusimilarity_jax.parallel import mesh as mesh_mod


class TestAutoFold:
    def test_fold_math(self, monkeypatch):
        # 10 GB free, 25% reserved -> 7.5 GB usable
        monkeypatch.setattr(
            mesh_mod, "available_device_memory", lambda devices=None: 10 * 2**30
        )
        gib = 2**30
        assert mesh_mod.auto_fold_factor(1 * gib) == 1
        assert mesh_mod.auto_fold_factor(7 * gib) == 1
        assert mesh_mod.auto_fold_factor(8 * gib) == 2
        assert mesh_mod.auto_fold_factor(15 * gib) == 2
        assert mesh_mod.auto_fold_factor(16 * gib) == 3
        assert mesh_mod.auto_fold_factor(60 * gib) == 8

    def test_unknown_memory_means_no_fold(self, monkeypatch):
        monkeypatch.setattr(
            mesh_mod, "available_device_memory", lambda devices=None: None
        )
        assert mesh_mod.auto_fold_factor(10**15) == 1

    def test_registry_bitcount_override_errors_when_insufficient(
        self, monkeypatch, rng
    ):
        from gpusimilarity_jax.models.registry import DatabaseRegistry
        import gpusimilarity_jax.models.registry as reg_mod

        # pretend only a tiny amount of memory is free -> needs fold 4
        monkeypatch.setattr(reg_mod, "auto_fold_factor", lambda b: 4)
        from conftest import random_fingerprint_data

        datas = [("d", random_fingerprint_data(rng, count=10))]
        # requesting full-width on-device storage must fail
        with pytest.raises(MemoryError):
            DatabaseRegistry._global_fold(datas, device_bitcount=1024)
        # requesting 128-bit (fold 8 >= 4) is allowed
        assert DatabaseRegistry._global_fold(datas, device_bitcount=128) == 8

    def test_mesh_shape(self):
        m = mesh_mod.make_mesh()
        assert m.shape[mesh_mod.SHARD_AXIS] == mesh_mod.device_count()
