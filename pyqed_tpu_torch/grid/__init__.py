from .spo import (SPO, SPO2, SPO3, SPON, SPO2NH, ResultSPO, ResultSPO2,
                  spo_from_reference)
