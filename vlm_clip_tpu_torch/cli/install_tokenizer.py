"""One-time CLIP tokenizer asset install (port of
``vlm_clip_tpu/cli/install_tokenizer.py``).

The reference gets exact tokenization implicitly through
``CLIPProcessor.from_pretrained`` (dataset.py:152-159). In a zero-egress
deployment the vocab must be materialized once from local files; after
that every ``get_tokenizer()`` call is token-exact with HF.

Usage:
    python -m vlm_clip_tpu_torch.cli.install_tokenizer SOURCE \\
        [--asset-dir DIR]

SOURCE is any of:
- the original openai ``bpe_simple_vocab_16e6.txt.gz``;
- an HF CLIP model/tokenizer directory (vocab.json + merges.txt);
- a direct path to a ``vocab.json`` (sibling merges.txt assumed).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("source", help="bpe .gz, HF dir, or vocab.json path")
    ap.add_argument("--asset-dir", default=None,
                    help="override the package asset dir")
    args = ap.parse_args(argv)

    from vlm_clip_tpu_torch.data.tokenizer import (CLIPBPETokenizer,
                                                   get_tokenizer,
                                                   install_tokenizer_asset)

    dest = install_tokenizer_asset(args.source, args.asset_dir)
    tok = get_tokenizer() if args.asset_dir is None else \
        CLIPBPETokenizer.from_files(f"{dest}/vocab.json",
                                    f"{dest}/merges.txt")
    if not isinstance(tok, CLIPBPETokenizer):
        print("install failed: get_tokenizer still degrades to hash")
        return 1
    ids, _ = tok(["a photo of a person expressing happiness"])
    print(f"installed CLIP BPE asset at {dest}; "
          f"vocab={len(tok.encoder)} sample ids={ids[0][:8].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
