"""The plain float32 references the check holds the program to; they
import nothing of the program."""
