"""Dataset splits: the reference's hard-coded track lists
(dcnet/softmax_viterbi.py:214-289). The port's own copy of
viterbi_spl_tpu/data/splits.py (NumPy and the standard library only)."""

from __future__ import annotations

import glob
import os

MEDLEYDB_TRAIN = [
    "AimeeNorwich_Child", "AlexanderRoss_GoodbyeBolero", "AlexanderRoss_VelvetCurtain",
    "AvaLuna_Waterduct", "BigTroubles_Phantom", "DreamersOfTheGhetto_HeavyLove",
    "FacesOnFilm_WaitingForGa", "FamilyBand_Again", "Handel_TornamiAVagheggiar",
    "HeladoNegro_MitadDelMundo", "HopAlong_SisterCities", "LizNelson_Coldwar",
    "LizNelson_ImComingHome", "LizNelson_Rainfall", "Meaxic_TakeAStep",
    "Meaxic_YouListen", "MusicDelta_80sRock", "MusicDelta_Beatles",
    "MusicDelta_Britpop", "MusicDelta_Country1", "MusicDelta_Country2",
    "MusicDelta_Disco", "MusicDelta_Grunge", "MusicDelta_Hendrix",
    "MusicDelta_Punk", "MusicDelta_Reggae", "MusicDelta_Rock",
    "MusicDelta_Rockabilly", "PurlingHiss_Lolita", "StevenClark_Bounty",
    "SweetLights_YouLetMeDown", "TheDistricts_Vermont",
    "TheScarletBrand_LesFleursDuMal", "TheSoSoGlos_Emergency", "Wolf_DieBekherte",
]

MEDLEYDB_VALIDATION = [
    "BrandonWebster_DontHearAThing", "BrandonWebster_YesSirICanFly",
    "ClaraBerryAndWooldog_AirTraffic", "ClaraBerryAndWooldog_Boys",
    "ClaraBerryAndWooldog_Stella", "ClaraBerryAndWooldog_TheBadGuys",
    "ClaraBerryAndWooldog_WaltzForMyVictims", "HezekiahJones_BorrowedHeart",
    "InvisibleFamiliars_DisturbingWildlife", "Mozart_DiesBildnis",
    "NightPanther_Fire", "SecretMountains_HighHorse", "Snowmine_Curfews",
]

MEDLEYDB_TEST = [
    "AClassicEducation_NightOwl", "Auctioneer_OurFutureFaces",
    "CelestialShore_DieForUs", "Creepoid_OldTree", "Debussy_LenfantProdigue",
    "MatthewEntwistle_DontYouEver", "MatthewEntwistle_Lontano",
    "Mozart_BesterJungling", "MusicDelta_Gospel", "PortStWillow_StayEven",
    "Schubert_Erstarrung", "StrandOfOaks_Spacestation",
]

assert len(MEDLEYDB_TRAIN) == 35
assert len(MEDLEYDB_VALIDATION) == 13
assert len(MEDLEYDB_TEST) == 12


def medleydb_splits() -> dict[str, list[str]]:
    return dict(
        training=list(MEDLEYDB_TRAIN),
        validation=list(MEDLEYDB_VALIDATION),
        test=list(MEDLEYDB_TEST),
    )


def adc04_track_ids() -> list[str]:
    return [
        "daisy1", "daisy2", "daisy3", "daisy4", "opera_fem2", "opera_fem4",
        "opera_male3", "opera_male5", "pop1", "pop2", "pop3", "pop4",
    ]


def mirex05_track_ids() -> list[str]:
    return [f"train{i:02d}" for i in range(1, 10)]


def mir1k_track_ids(root: str | None = None) -> list[str]:
    """Globbed from $mir1k/Wavfile (1000 tracks in the full dataset)."""
    root = root or os.environ["mir1k"]
    files = glob.glob(os.path.join(root, "Wavfile", "*.wav"))
    return sorted({os.path.basename(f)[:-4] for f in files})


def rwc_track_ids() -> list[str]:
    return [str(i) for i in range(100)]
