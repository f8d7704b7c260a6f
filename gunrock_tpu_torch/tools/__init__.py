"""The port's tools, run as ``python -m gunrock_tpu_torch.tools.<name>``:
``card_profile`` (profiles on the card), ``convert``,
``dryrun_multichip`` and ``shard_ranks``."""
