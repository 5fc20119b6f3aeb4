from .cli import entry_main

entry_main()
