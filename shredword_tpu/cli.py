"""Command-line interface: ``python -m shredword_tpu <cmd> ...``.

The reference has no CLI (config only via the Python ctor,
trainer.py:6-12); this is a greenfield subsystem per SURVEY.md §5
("Config / flag system: ... No CLI").  Subcommands:

  train    corpus -> .model/.vocab (reference binary format, bpe.cpp:678)
  encode   text -> token ids using a trained model
  decode   token ids -> text
  convert  between the binary-triple and "shredword v1" text formats
  info     summarize a model file
  daemon   warm-process server so repeat commands skip JIT/startup cost

With ``SHREDWORD_DAEMON=1`` every command routes through the daemon
(auto-starting it), making the Nth CLI invocation as cheap as the
reference's compiled-.so workflow — see daemon.py for the measured
rationale.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _add_train(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("train", help="train a BPE model from a corpus")
    p.add_argument("--corpus", required=True)
    p.add_argument("--model", required=True, help="output .model path")
    p.add_argument("--vocab", default=None, help="output .vocab path")
    p.add_argument("--vocab-size", type=int, default=8192)
    p.add_argument("--unk-id", type=int, default=-1)
    p.add_argument("--coverage", type=float, default=0.995)
    p.add_argument("--min-pair-freq", type=int, default=2000)
    p.add_argument("--backend", choices=("device", "cpu"),
                   default="device")
    p.add_argument("--engine", choices=("auto", "hist", "giant", "flat"),
                   default="auto",
                   help="device merge-loop engine (hist and giant both "
                        "name the pair-table engine, vocab <= 32768; "
                        "auto routes by device and vocab)")
    p.add_argument("--tie-break", choices=("lex", "faithful"),
                   default="lex")
    p.add_argument("--max-merges", type=int, default=None)
    p.add_argument("--shards", type=int, default=0,
                   help="data-parallel corpus shards over the device "
                        "mesh (0 = single device; merge sequence stays "
                        "bit-identical)")
    p.add_argument("--checkpoint-path", default=None,
                   help="write a resumable checkpoint here during training")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="merges between checkpoints")
    p.add_argument("--resume", default=None,
                   help="resume from this checkpoint file")


def _add_io(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", required=True, help="trained .model path")
    p.add_argument("--input", default="-",
                   help="input file ('-' = stdin)")
    p.add_argument("--output", default="-",
                   help="output file ('-' = stdout)")


def _read(path: str) -> str:
    if path == "-":
        return sys.stdin.read()
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


def _write(path: str, text: str) -> None:
    if path == "-":
        sys.stdout.write(text)
    else:
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    # Opt-in daemon routing: run the command in the warm server process
    # (auto-started) instead of paying per-process JIT/startup cost.
    # The server itself calls main() with _SHREDWORD_IN_DAEMON set, so
    # this cannot recurse; the daemon subcommand always runs locally.
    if (os.environ.get("SHREDWORD_DAEMON") == "1"
            and not os.environ.get("_SHREDWORD_IN_DAEMON")
            and argv[:1] != ["daemon"]):
        from . import daemon
        rc = daemon.run_client(argv)
        if rc is not None:
            return rc
        # Running locally could open the device while a daemon that is
        # still starting holds it; fail instead.
        print("error: SHREDWORD_DAEMON=1 but the daemon could not be "
              "reached or started; run `shredword-tpu daemon status`, or "
              "unset SHREDWORD_DAEMON to run this command in-process",
              file=sys.stderr)
        return 1

    ap = argparse.ArgumentParser(prog="shredword_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    _add_train(sub)

    pe = sub.add_parser("encode", help="encode text to token ids")
    _add_io(pe)
    pe.add_argument("--backend", choices=("device", "cpu"), default="cpu")

    pd = sub.add_parser("decode", help="decode token ids to text")
    _add_io(pd)

    pc = sub.add_parser("convert",
                        help="convert between model formats")
    pc.add_argument("src")
    pc.add_argument("dst")
    pc.add_argument("--pattern", default="")

    pi = sub.add_parser("info", help="summarize a model file")
    pi.add_argument("model")

    pu = sub.add_parser("train-unigram",
                        help="train a unigram LM tokenizer")
    pu.add_argument("--corpus", required=True)
    pu.add_argument("--model", required=True)
    pu.add_argument("--vocab-size", type=int, default=8192)
    pu.add_argument("--seed-size", type=int, default=100_000)
    pu.add_argument("--max-piece-len", type=int, default=15)
    pu.add_argument("--em-rounds", type=int, default=2)
    pu.add_argument("--backend", choices=("device", "cpu"),
                    default="device")
    pu.add_argument("--shards", type=int, default=0,
                    help="data-parallel word shards over the device "
                         "mesh (0 = single device)")

    pda = sub.add_parser(
        "daemon", help="manage the warm-process command server")
    pda.add_argument("action",
                     choices=("start", "stop", "status", "serve"))
    pda.add_argument("--socket", default=None,
                     help="unix socket path (default: "
                          "$SHREDWORD_DAEMON_SOCKET or per-uid /tmp)")
    pda.add_argument("--idle-timeout", type=float, default=3600.0,
                     help="seconds without a request before the server "
                          "exits (default 1h)")

    args = ap.parse_args(argv)

    if args.cmd == "daemon":
        from . import daemon
        if args.action == "serve":            # foreground server loop
            return daemon.serve(args.socket,
                                idle_timeout=args.idle_timeout)
        if args.action == "start":
            ok = daemon.start(args.socket,
                              idle_timeout=args.idle_timeout)
            print("daemon running" if ok else "daemon failed to start")
            return 0 if ok else 1
        if args.action == "stop":
            ok = daemon.stop(args.socket)
            print("daemon stopped" if ok else "no daemon running")
            return 0 if ok else 1
        ok = daemon.ping(args.socket)
        print("daemon running" if ok else "no daemon running")
        return 0 if ok else 1

    if args.cmd == "train":
        from .models.bpe import BPETrainer
        t = BPETrainer(target_vocab_size=args.vocab_size,
                       unk_id=args.unk_id,
                       character_coverage=args.coverage,
                       min_pair_freq=args.min_pair_freq,
                       backend=args.backend, engine=args.engine,
                       tie_break=args.tie_break,
                       checkpoint_path=args.checkpoint_path,
                       checkpoint_every=args.checkpoint_every,
                       shards=args.shards)
        t.load_corpus(args.corpus)
        if args.resume:
            n0 = t.load_checkpoint(args.resume)
            print(f"resuming after {n0} merges from {args.resume}")
        n = t.train(args.max_merges)
        vocab = args.vocab or (args.model.rsplit(".", 1)[0] + ".vocab")
        t.save(args.model, vocab)
        t.destroy()
        print(f"trained {n} merges -> {args.model}, {vocab}")
        return 0

    if args.cmd == "encode":
        from .tokenizer import Tokenizer
        tok = Tokenizer.load(args.model, backend=args.backend)
        ids = tok.encode(_read(args.input), allowed_special="all")
        _write(args.output, " ".join(map(str, ids)) + "\n")
        return 0

    if args.cmd == "decode":
        from .tokenizer import Tokenizer
        tok = Tokenizer.load(args.model)
        ids = [int(x) for x in _read(args.input).split()]
        _write(args.output, tok.decode(ids))
        return 0

    if args.cmd == "convert":
        from . import serialization
        serialization.convert(args.src, args.dst, pattern=args.pattern)
        print(f"converted {args.src} -> {args.dst}")
        return 0

    if args.cmd == "info":
        from . import serialization
        merges, pattern, special = serialization.read_model_any(args.model)
        toks = serialization.token_strings(np.asarray(merges))
        longest = max(toks, key=len) if toks else b""
        print(f"model:    {args.model}")
        print(f"merges:   {len(merges)}")
        print(f"vocab:    {256 + len(merges)}")
        print(f"pattern:  {pattern!r}")
        print(f"specials: {len(special)}")
        print(f"longest token: {longest!r} ({len(longest)} bytes)")
        return 0

    if args.cmd == "train-unigram":
        from .models.unigram import UnigramTrainer
        t = UnigramTrainer(target_vocab_size=args.vocab_size,
                           seed_size=args.seed_size,
                           max_piece_len=args.max_piece_len,
                           num_em_rounds=args.em_rounds,
                           backend=args.backend, shards=args.shards)
        t.load_corpus(args.corpus)
        n = t.train()
        t.save(args.model)
        print(f"trained unigram model with {n} pieces -> {args.model}")
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
