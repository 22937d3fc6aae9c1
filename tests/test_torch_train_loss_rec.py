"""``LM.loss`` and every parameter's gradient against the reference's
``jax.value_and_grad(LM.loss)`` for the SSD, RG-LRU, encoder-decoder and
local-window SMOKE models, on the CPU (``tests/_train_parity.py`` states
the bars)."""
import pytest

torch = pytest.importorskip("torch")

import _train_parity as T  # noqa: E402


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b",
                                  "whisper-medium", "gemma3-4b"])
def test_loss_and_grads(arch):
    T.check_loss_and_grads(arch)
