"""Plain references of the configurations' chains, and POCSAG written out
plainly; none of them imports the program."""
