"""Port parity: DDPM-DiT training through ``Trainer.fit`` against the JAX
package's (``torch_train_parity`` says how).

DiT4DFactorized at depth 2, hidden 64, 4 heads, on an 8×12 grid; with
dropout off its training attention runs through the kernel wrapper's
autograd Function, spatial and temporal (Sq ≠ Sk) alike.
"""

from torch_train_parity import check_port_against, jax_reference


def test_fit_matches_jax(tmp_path):
    check_port_against(jax_reference("DDPM-DiT", tmp_path / "jax"), tmp_path)
