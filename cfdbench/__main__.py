import sys

from cfdbench.run import main

sys.exit(main())
