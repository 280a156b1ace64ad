"""Batched serving on the PyTorch port: prefill a batch of prompts, decode
with a KV cache, report throughput; on the card by default.

  PYTHONPATH=src python examples/torch_serve_lm.py --arch gemma3-12b --gen 24
  PYTHONPATH=src python examples/torch_serve_lm.py --device cpu --gen 4

The registry's reduced (smoke) config of ``--arch``, seeded weights.
"""
import argparse

from repro_torch.launch.serve import serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    r = serve(args.arch, smoke=True, batch=args.batch,
              prompt_len=args.prompt_len, gen=args.gen, device=args.device)
    print(f"batch={args.batch} prompt={args.prompt_len} gen={args.gen}")
    print(f"prefill: {r['prefill_s']:.2f}s   decode: {r['decode_s']:.2f}s "
          f"({r['decode_tok_s']:.1f} tok/s)")
    print(f"sample continuation ids: {r['generated'][0][:10].tolist()}")
    return r


if __name__ == "__main__":
    main()
