"""``python -m ceracoder_tpu_torch JOB_FILE ADDR PORT [options]`` — the
ceracoder-equivalent CLI app, on the card."""

import sys

from ceracoder_tpu_torch.app.main import main

if __name__ == "__main__":
    sys.exit(main())
