"""The device boundary: compile-cache placement, the optional `regex`
package, the Unigram E-step routing, chip_smoke.py's refusal to run
without a GPU, and a GPU-only check."""

import os
import shutil
import subprocess
import sys

import pytest

from shredword_tpu import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env=None, cwd=REPO, timeout=300):
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


# ---------------------------------------------------------------------
# compile cache: JAX_COMPILATION_CACHE_DIR wins, else <checkout>/.jax_cache
# ---------------------------------------------------------------------

@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir_rule(tmp_path, env_dir):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    p = _run("import shredword_tpu.ops.bpe_ops, jax; "
             "print(jax.config.jax_compilation_cache_dir)", env=env)
    assert p.returncode == 0, p.stderr
    want = str(tmp_path / "cc") if env_dir else os.path.join(
        REPO, ".jax_cache")
    assert p.stdout.strip() == want


# ---------------------------------------------------------------------
# regex is optional: the main path imports and runs without it
# ---------------------------------------------------------------------

_NO_REGEX = "import sys; sys.modules['regex'] = None\n"


@pytest.mark.parametrize("case,code", [
    ("import", "import shredword_tpu\n"
               "from shredword_tpu import (BPETrainer, Tokenizer, "
               "UnigramTrainer, cli)\nprint('OK')"),
    ("gpt_and_specials",
     "from shredword_tpu import BPETrainer, Tokenizer\n"
     "t = BPETrainer(target_vocab_size=280, unk_id=-1, min_pair_freq=2,"
     " character_coverage=1.0)\n"
     "t.load_corpus_bytes(b\"we'll see 123 cats, won't we?\\n\" * 40)\n"
     "t.train()\n"
     "tok = Tokenizer(merges=t.merges, pattern='gpt',"
     " special_tokens={'<|eot|>': 1000})\n"
     "s = \"we'll see 45 dogs <|eot|> won't we?\"\n"
     "ids = tok.encode(s, allowed_special='all')\n"
     "assert 1000 in ids and tok.decode(ids) == s\n"
     "print('OK')"),
    ("other_pattern_raises",
     "from shredword_tpu import pretokenize\n"
     "try:\n"
     "    pretokenize.regex_split('a b', 'word')\n"
     "except ImportError as e:\n"
     "    assert 'regex' in str(e) and repr(pretokenize.PATTERN_WORD)"
     " in str(e), e\n"
     "    print('OK')\n"),
])
def test_main_path_without_regex(case, code):
    p = _run(_NO_REGEX + code)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().endswith("OK")


def test_special_token_split_is_literal():
    from shredword_tpu import pretokenize
    parts = pretokenize.split_special(
        "a<|x|>b.*c<|x|>", {"<|x|>": 900, ".*": 901})
    assert parts == [(False, "a"), (True, "<|x|>"), (False, "b"),
                     (True, ".*"), (False, "c"), (True, "<|x|>")]


# ---------------------------------------------------------------------
# Unigram E-step: device on an accelerator, numpy on a CPU-only host
# ---------------------------------------------------------------------

@pytest.mark.parametrize("accel,backend,on_device", [
    (True, "device", True),
    (False, "device", False),
    (True, "cpu", False),
])
def test_unigram_estep_routing(tmp_path, monkeypatch, accel, backend,
                               on_device):
    from shredword_tpu import UnigramTrainer
    from shredword_tpu.ops import unigram_ops
    monkeypatch.setattr(device, "is_accelerator", lambda: accel)
    used = []
    orig_dev = unigram_ops.forward_backward_resident
    orig_host = unigram_ops.forward_backward
    monkeypatch.setattr(
        unigram_ops, "forward_backward_resident",
        lambda *a, **k: used.append("device") or orig_dev(*a, **k))
    monkeypatch.setattr(
        unigram_ops, "forward_backward",
        lambda *a, **k: used.append(k.get("backend")) or orig_host(*a, **k))
    corpus = tmp_path / "c.txt"
    corpus.write_text("the cat sat on the mat\na cat and a hat\n" * 20)
    t = UnigramTrainer(target_vocab_size=40, seed_size=300,
                       max_word_len=16, num_em_rounds=1, backend=backend)
    t.load_corpus(str(corpus))
    t.train()
    assert used and set(used) == {"device" if on_device else "cpu"}


# ---------------------------------------------------------------------
# chip_smoke.py on a host without a GPU
# ---------------------------------------------------------------------

def _path_without_smi():
    return os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvidia-smi")))


@pytest.mark.parametrize("case", ["no_smi", "fake_smi", "lone_script"])
def test_chip_smoke_fails_without_gpu(tmp_path, case):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PATH"] = _path_without_smi()
    cwd = REPO
    script = os.path.join(REPO, "chip_smoke.py")
    if case != "no_smi":       # a card name but no GPU for JAX
        fake = tmp_path / "bin"
        fake.mkdir()
        smi = fake / "nvidia-smi"
        smi.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W'\n")
        smi.chmod(0o755)
        env["PATH"] = str(fake) + os.pathsep + env["PATH"]
    if case == "lone_script":
        cwd = str(tmp_path / "alone")
        os.makedirs(cwd)
        script = shutil.copy(script, cwd)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, script], env=env, cwd=cwd,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


# ---------------------------------------------------------------------
# GPU only (skips here): table == flat and device encode == cpu encode
# ---------------------------------------------------------------------

_GPU_CHECK = r"""
import numpy as np
from shredword_tpu import BPETrainer, Tokenizer, device
assert device.platform() == "gpu", device.platform()
data = b"".join(b"w%d x%d y%d\n" % (i % 97, i % 13, i % 7)
                for i in range(4000))
out = {}
for engine in ("auto", "flat", "hist"):
    t = BPETrainer(target_vocab_size=600, unk_id=-1, min_pair_freq=2,
                   character_coverage=1.0, engine=engine)
    t.load_corpus_bytes(data)
    t.train()
    out[engine] = t.merges
assert np.array_equal(out["auto"], out["flat"])
assert np.array_equal(out["hist"], out["flat"])
text = data.decode()[:50000]
dev = Tokenizer(merges=out["flat"], backend="device")
cpu = Tokenizer(merges=out["flat"], backend="cpu")
ids = dev.encode_array(text)
assert np.array_equal(ids, cpu.encode_array(text))
assert dev.decode(ids) == text
print("GPU_OK")
"""


@pytest.mark.gpu
def test_gpu_engines_and_encode_agree(gpu_env):
    p = subprocess.run([sys.executable, "-c", _GPU_CHECK], env=gpu_env,
                       cwd=REPO, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "GPU_OK" in p.stdout
