"""``python -m semi_supervised_asr_tpu_torch.decode --config ...`` =
main --test."""

import sys

from semi_supervised_asr_tpu_torch.main import main

if __name__ == "__main__":
    sys.exit(main(["--test", *sys.argv[1:]]))
