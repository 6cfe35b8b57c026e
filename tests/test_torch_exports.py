"""Every subpackage of the JAX package has a port counterpart, and the
port's ``__all__`` holds every name of the JAX subpackage's ``__all__``
(the port may export more). A name the port does not export yet would be
listed in ``PENDING`` with the ROADMAP item that brings it; none is."""

import importlib
import pkgutil

import pytest
import torch

torch.set_num_threads(2)

JAX_PKG = "quantized_distillation_tpu"
PORT_PKG = "quantized_distillation_tpu_torch"
SUBPACKAGES = ("data", "kernels", "models", "native", "ops", "parallel", "serve", "train",
               "utils")
# subpackage → {name: ROADMAP item that brings it}
PENDING = {}


def test_every_jax_subpackage_is_listed():
    jax_pkg = importlib.import_module(JAX_PKG)
    found = {m.name for m in pkgutil.iter_modules(jax_pkg.__path__) if m.ispkg}
    assert found == set(SUBPACKAGES)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_cover_jax(sub):
    jax_mod = importlib.import_module(f"{JAX_PKG}.{sub}")
    port_mod = importlib.import_module(f"{PORT_PKG}.{sub}")
    want = set(getattr(jax_mod, "__all__", ()))
    have = set(getattr(port_mod, "__all__", ()))
    pending = PENDING.get(sub, {})
    assert sorted(want - have - set(pending)) == []
    assert not set(pending) & have, "a pending name is exported: drop it from PENDING"
    for name in have:  # every exported name exists
        assert hasattr(port_mod, name), name
