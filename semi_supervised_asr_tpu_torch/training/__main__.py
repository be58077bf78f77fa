"""``python -m semi_supervised_asr_tpu_torch.training --config ...`` =
main --train."""

import sys

from semi_supervised_asr_tpu_torch.main import main

if __name__ == "__main__":
    sys.exit(main(["--train", *sys.argv[1:]]))
