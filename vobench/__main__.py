import sys

from vobench.harness import main

sys.exit(main())
