"""``paddle_tpu_torch.models.bert`` against ``paddle_tpu/models/bert.py``
at ``bench.py``'s CPU size for BERT: two layers, hidden 128, 4 heads of
32, intermediate 256, vocab 512; batch 2 x 64, AdamW lr 1e-3 (the bench
uses 3e-5; a larger step moves the params enough for the comparison
after 3 steps to see them).  State keys letter for letter; logits, loss
and every gradient at each of 3 steps and every param after them within
relative norm 1e-4 (the key biases, whose gradient is rounding noise,
within 6 lr: ``torch_model_parity.check_state``).  Once unmasked (K1/K2
on the card) and once with a ``[B, 1, 1, S]`` bool key-padding mask (the
masked flash route, K8 on the card); the loss reads only row 0 of each
sequence, through the pooler."""
import numpy as np
import pytest

from paddle_tpu.models import bert as JB
from paddle_tpu_torch.models import bert as TB
from torch_model_parity import carry, check_runs, check_state, \
    reference_init, train_both
from torch_op_parity import cpu_place, rng

_cpu = pytest.fixture(autouse=True)(cpu_place)
TOL = 1e-4
LR = 1e-3
SIZE = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256)
R = rng(4)
IDS = R.integers(0, 512, (2, 64)).astype(np.int64)
Y = R.integers(0, 2, (2,)).astype(np.int64)
MASK = np.ones((2, 1, 1, 64), bool)
MASK[1, ..., 40:] = False


def _pair():
    with reference_init():
        jm = JB.BertForSequenceClassification(JB.BertConfig(**SIZE))
    tm = TB.BertForSequenceClassification(TB.BertConfig(**SIZE))
    carry(jm, tm)
    return jm, tm


def _adamw(M, m):
    return M.optimizer.AdamW(learning_rate=LR, parameters=m.parameters())


def _loss(masked):
    def fn(M, m, ids, y, mask=None):
        logits = m(ids, attn_mask=mask if masked else None)
        return logits, M.nn.functional.cross_entropy(logits, y)
    return fn


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask"])
def test_bert_training_matches_the_reference(masked):
    jm, tm = _pair()
    batch = (IDS, Y, MASK) if masked else (IDS, Y)
    jrun, trun = train_both(jm, tm, _adamw, _loss(masked), batch, 3)
    check_runs(jrun, trun, TOL)
    # the key bias's gradient is zero in exact arithmetic (softmax
    # ignores a shift common to all keys): AdamW moves it by up to about
    # lr a step either way on each side
    check_state(jm, tm, TOL, noise={"attention.key.bias": 2 * 3 * LR})
    assert trun[-1][1] < trun[0][1]


def test_bert_config_and_keys():
    c = TB.BertConfig()
    assert (c.hidden_size, c.num_attention_heads, c.head_dim) == \
        (768, 12, 64)
    assert TB.BertConfig().__dict__ == JB.BertConfig().__dict__
