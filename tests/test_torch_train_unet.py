"""Port parity: DDPM-UNet training through ``Trainer.fit`` against the JAX
package's (``torch_train_parity`` says how), with each conv kernel's path.

UNet at base 8, two levels, attention at level 1, on an 8×12 grid, with
CFG condition dropout on (``CFG_DROP_PROB`` 0.5), so the keep mask crosses
over too.  The JAX side runs once for both conv impls.
"""

import pytest

from torch_train_parity import check_port_against, jax_reference


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_reference("DDPM-UNet", tmp_path_factory.mktemp("jax"), cfg_drop=0.5)


@pytest.mark.parametrize("conv_impl", ["im2col", "tapgemm"])
def test_fit_matches_jax(reference, conv_impl, tmp_path):
    check_port_against(reference, tmp_path, conv_impl)
